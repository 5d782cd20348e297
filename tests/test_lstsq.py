"""Least-squares solver vs np.linalg.lstsq (the reference's oracle,
``python/linear_least_sqare.py:60-63``) plus the regression-style fixtures
and ill-conditioning study from that file.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mixedprecisionblockqr_tpu.models.lstsq import back_substitution, lstsq
from mixedprecisionblockqr_tpu.models.slam import gauss_newton_step
from mixedprecisionblockqr_tpu.ops.policy import POLICY_MIXED
from mixedprecisionblockqr_tpu.utils.datagen import conditioned_matrix


def _fixture_cases():
    # Mirrors the reference's regression datasets
    # (linear_least_sqare.py:27-45): rows are samples, last row is y.
    rng = np.random.default_rng(0)
    return [
        np.array([[1, 2, 3, 4], [6, 5, 7, 10]], float),
        np.array(
            [[1, 2, 3], [4, 5, 6], [7, 8, 7], [4, 2, 3], [4, 2, 2],
             [10, 20, 30]], float,
        ),
        rng.random((100, 100)),
        conditioned_matrix(100, 1e5, seed=1),
    ]


def test_lstsq_matches_numpy_fixtures():
    for dataset in _fixture_cases():
        y = dataset[-1]
        x = dataset[:-1].T
        A = np.c_[np.ones(x.shape[0]), x].astype(np.float32)
        if A.shape[0] < A.shape[1]:
            # Underdetermined system: the reference's own check on this
            # fixture is vacuous (``assert np.allclose(X, X)``,
            # linear_least_sqare.py:63); we require m >= n.
            continue
        got = np.asarray(lstsq(A, y.astype(np.float32), block_size=16))
        want, *_ = np.linalg.lstsq(A, y, rcond=None)
        resid_got = np.linalg.norm(A @ got - y)
        resid_want = np.linalg.norm(A @ want - y)
        assert resid_got <= resid_want * (1 + 1e-3) + 1e-3


def test_lstsq_tall():
    rng = np.random.default_rng(2)
    A = rng.random((400, 60)).astype(np.float32)
    xtrue = rng.random(60).astype(np.float32)
    b = A @ xtrue
    x = np.asarray(lstsq(A, b))
    np.testing.assert_allclose(x, xtrue, atol=5e-3)


def test_lstsq_quality_passthrough():
    """lstsq forwards the quality-ladder knob to the blocked driver (the
    same API surface as qr(quality=...)); off-GPU auto resolves to the
    householder oracle so this pins the plumbing, not the tier choice."""
    rng = np.random.default_rng(3)
    A = rng.random((256, 128)).astype(np.float32)
    xtrue = rng.random(128).astype(np.float32)
    b = A @ xtrue
    x = np.asarray(lstsq(A, b, panel_method="auto", quality="high"))
    np.testing.assert_allclose(x, xtrue, atol=5e-3)
    with pytest.raises(ValueError):
        lstsq(A, b, panel_method="householder", quality="high")


def test_lstsq_underdetermined_min_norm():
    """m < n (review finding: used to crash with an opaque matmul shape
    error) routes to the pivoted min-norm path — np.linalg.lstsq
    semantics."""
    rng = np.random.default_rng(8)
    A = rng.random((64, 128)).astype(np.float32)
    b = rng.random(64).astype(np.float32)
    x = np.asarray(lstsq(A, b))
    xr, *_ = np.linalg.lstsq(A.astype(np.float64), b.astype(np.float64),
                             rcond=None)
    assert x.shape == (128,)
    resid = np.linalg.norm(A @ x - b)
    resid_ref = np.linalg.norm(A @ xr - b)
    assert abs(resid - resid_ref) < 1e-4
    # Min-norm: same solution norm as numpy's pseudo-inverse solution.
    np.testing.assert_allclose(np.linalg.norm(x), np.linalg.norm(xr),
                               rtol=1e-4)


def test_lstsq_refine_path_guards():
    """The refine_steps path uses CAQR stored factors (review findings):
    quality= must be rejected, not silently ignored, and the
    rank-deficiency tripwire must still reroute to the pivoted min-norm
    path instead of iterating through tiny pivots to inf/NaN."""
    rng = np.random.default_rng(9)
    A = rng.random((128, 64)).astype(np.float32)
    b = rng.random(128).astype(np.float32)
    with pytest.raises(ValueError, match="quality"):
        lstsq(A, b, panel_method="auto", quality="high", refine_steps=1)
    # Rank-deficient: duplicate a column, solve with refinement.
    Ad = A.copy()
    Ad[:, -1] = Ad[:, 0]
    x = np.asarray(lstsq(Ad, b, refine_steps=2))
    assert np.all(np.isfinite(x))
    xr, *_ = np.linalg.lstsq(Ad.astype(np.float64), b.astype(np.float64),
                             rcond=None)
    assert abs(np.linalg.norm(Ad @ x - b) - np.linalg.norm(Ad @ xr - b)) < 1e-3


def test_lstsq_tsqr_method():
    rng = np.random.default_rng(3)
    A = rng.random((2048, 24)).astype(np.float32)
    b = rng.random(2048).astype(np.float32)
    x = np.asarray(lstsq(A, b, method="tsqr"))
    want, *_ = np.linalg.lstsq(A, b, rcond=None)
    np.testing.assert_allclose(x, want, atol=1e-3)


def test_back_substitution_upper_and_lower():
    rng = np.random.default_rng(4)
    n = 100
    R = np.triu(rng.random((n, n))).astype(np.float32) + 3 * np.eye(n, dtype=np.float32)
    b = rng.random(n).astype(np.float32)
    x = np.asarray(back_substitution(R, b, block_size=16))
    np.testing.assert_allclose(R @ x, b, atol=1e-3)
    L = R.T.copy()
    xl = np.asarray(back_substitution(L, b, lower=True, block_size=16))
    np.testing.assert_allclose(L @ xl, b, atol=1e-3)


def test_back_substitution_matrix_rhs():
    rng = np.random.default_rng(5)
    n = 32
    R = np.triu(rng.random((n, n))).astype(np.float32) + 2 * np.eye(n, dtype=np.float32)
    B = rng.random((n, 3)).astype(np.float32)
    X = np.asarray(back_substitution(R, B, block_size=8))
    np.testing.assert_allclose(R @ X, B, atol=1e-4)


def test_gauss_newton_step_descends():
    rng = np.random.default_rng(6)
    J = rng.random((200, 40)).astype(np.float32)
    r0 = rng.random(200).astype(np.float32)
    dx = np.asarray(gauss_newton_step(J, r0, policy=POLICY_MIXED))
    assert np.linalg.norm(r0 + J @ dx) < np.linalg.norm(r0)
    # Damped variant stays finite and shorter.
    dx_damped = np.asarray(gauss_newton_step(J, r0, damping=10.0))
    assert np.isfinite(dx_damped).all()
    assert np.linalg.norm(dx_damped) < np.linalg.norm(dx) * 1.01


def test_ill_conditioned_sensitivity():
    """The reference's ill-conditioning experiment
    (linear_least_sqare.py:47-58): perturbing a near-singular system
    produces solution changes ~ cond * delta."""
    A = np.array([[1.0, 0.999], [0.999, 1.0]], np.float32)
    y = np.array([1.0, 0.0], np.float32)
    x0 = np.asarray(lstsq(A, y, block_size=2))
    A2 = A.copy()
    A2[0, 1] += 1e-4
    A2[1, 0] += 1e-4
    x1 = np.asarray(lstsq(A2, y, block_size=2))
    # amplification well above the perturbation scale
    assert np.linalg.norm(x0 - x1) > 10 * 1e-4


def test_lstsq_batched():
    from mixedprecisionblockqr_tpu.models.lstsq import lstsq_batched

    rng = np.random.default_rng(7)
    A = rng.random((4, 80, 32)).astype(np.float32)
    xt = rng.random((4, 32)).astype(np.float32)
    b = np.einsum("bmn,bn->bm", A, xt)
    X = np.asarray(lstsq_batched(A, b, block_size=16))
    np.testing.assert_allclose(X, xt, atol=5e-3)


def test_lstsq_iterative_refinement():
    """Refinement sweeps recover accuracy on a conditioned system."""
    A = conditioned_matrix(96, 1e5, seed=9).astype(np.float32)
    rng = np.random.default_rng(10)
    xt = rng.random(96).astype(np.float32)
    b = (A.astype(np.float64) @ xt).astype(np.float32)
    x0 = np.asarray(lstsq(A, b, block_size=32))
    x2 = np.asarray(lstsq(A, b, block_size=32, refine_steps=2))
    e0 = np.linalg.norm(x0 - xt)
    e2 = np.linalg.norm(x2 - xt)
    assert e2 < e0 * 0.5, (e0, e2)


def test_rls_streaming_matches_stacked_oracle():
    """Recursive least squares: rls_init + streamed rls_update batches
    must reproduce np.linalg.lstsq of the fully stacked system — the
    square-root-information-filter formulation of the SLAM incremental
    solve (new measurement rows at O(n^2) each, no refactorization)."""
    from mixedprecisionblockqr_tpu.models.lstsq import (
        rls_init,
        rls_solve,
        rls_update,
    )

    rng = np.random.default_rng(5)
    A = rng.standard_normal((64, 12)).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    st = rls_init(A, b)
    x_ref, *_ = np.linalg.lstsq(A.astype(np.float64), b.astype(np.float64),
                                rcond=None)
    np.testing.assert_allclose(np.asarray(rls_solve(st)), x_ref, atol=1e-4)
    rows = rng.standard_normal((10, 12)).astype(np.float32)
    betas = rng.standard_normal(10).astype(np.float32)
    st = rls_update(st, rows[:4], betas[:4])   # batch fold
    st = rls_update(st, rows[4], betas[4])     # single-row fold
    st = rls_update(st, rows[5:], betas[5:])
    A2 = np.vstack([A, rows])
    b2 = np.append(b, betas)
    x_ref2, *_ = np.linalg.lstsq(A2.astype(np.float64),
                                 b2.astype(np.float64), rcond=None)
    np.testing.assert_allclose(np.asarray(rls_solve(st)), x_ref2, atol=1e-4)
    # State stays exactly triangular (streaming never degrades structure).
    assert np.allclose(np.tril(np.asarray(st.R), -1), 0.0)


def test_rls_multi_rhs():
    from mixedprecisionblockqr_tpu.models.lstsq import (
        rls_init,
        rls_solve,
        rls_update,
    )

    rng = np.random.default_rng(6)
    A = rng.standard_normal((40, 8)).astype(np.float32)
    B = rng.standard_normal((40, 3)).astype(np.float32)
    st = rls_init(A, B)
    rows = rng.standard_normal((5, 8)).astype(np.float32)
    betas = rng.standard_normal((5, 3)).astype(np.float32)
    st = rls_update(st, rows, betas)
    X = np.asarray(rls_solve(st))
    A2 = np.vstack([A, rows])
    B2 = np.vstack([B, betas])
    X_ref, *_ = np.linalg.lstsq(A2.astype(np.float64), B2.astype(np.float64),
                                rcond=None)
    np.testing.assert_allclose(X, X_ref, atol=1e-4)
