"""Column-pivoted QR + rank-deficient least squares.

Oracles: ``scipy.linalg.qr(pivoting=True)`` (the same algorithm family as
the reference's Eigen ``colPivHouseholderQr`` solver oracle,
``Cuda/QR/Solver/solver.cu:21-32``) and ``np.linalg.lstsq`` (min-norm);
fixtures include the reference's rank-deficient matrices
(``python/test_data.py:38-57``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg

from mixedprecisionblockqr_tpu.models.lstsq import lstsq, lstsq_pivoted
from mixedprecisionblockqr_tpu.ops.pivoted import (
    numerical_rank,
    pivoted_qr,
    pivoted_qr_qtb,
)


def _check_pivoted(a, rtol=2e-5):
    Q, R, perm = pivoted_qr(a, mode="reduced")
    Q, R, perm = np.asarray(Q), np.asarray(R), np.asarray(perm)
    m, n = a.shape
    k = min(m, n)
    # 1. reconstruction: A[:, perm] = Q R
    scale = max(np.linalg.norm(a), 1e-30)
    assert np.linalg.norm(a[:, perm] - Q @ R) / scale < rtol
    # 2. orthonormal Q
    assert np.max(np.abs(Q.T @ Q - np.eye(k))) < rtol
    # 3. diagonal decay invariant (non-increasing magnitudes)
    d = np.abs(np.diag(R))
    assert np.all(d[:-1] >= d[1:] - rtol * (d[0] + 1e-30))
    # 4. R-diagonal parity with scipy's pivoted QR (sign-free)
    _, Rs, _ = scipy.linalg.qr(a.astype(np.float64), pivoting=True)
    ds = np.abs(np.diag(Rs))[:k]
    np.testing.assert_allclose(d, ds, rtol=1e-3, atol=rtol * (ds.max() + 1))
    return Q, R, perm


@pytest.mark.parametrize("m,n", [(16, 16), (48, 32), (32, 48), (100, 100)])
def test_pivoted_qr_random(m, n):
    a = np.random.default_rng(m + n).standard_normal((m, n)).astype(np.float32)
    _check_pivoted(a)


def test_pivoted_qr_graded_columns():
    # Columns with wildly different norms MUST be reordered by magnitude.
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((64, 8)) * np.logspace(0, -6, 8)[::-1]).astype(
        np.float32
    )
    Q, R, perm = _check_pivoted(a)
    # the largest-norm (last) column pivots to the front
    assert perm[0] == 7


def test_pivoted_qr_reference_rank_deficient_fixtures():
    """The reference's 'strange matrices' (python/test_data.py:38-57):
    rank-1 repeated rows, diagonal, single-nonzero-row."""
    fixtures = [
        (np.array([[1, 2, 3], [1, 2, 3], [1, 2, 3]], np.float32), 1),
        (np.array([[1, 0, 0], [0, 2, 0], [0, 0, 3]], np.float32), 3),
        (np.array([[1, 2, 3], [0, 0, 0], [0, 0, 0]], np.float32), 1),
    ]
    for a, true_rank in fixtures:
        Q, R, perm = pivoted_qr(a, mode="reduced")
        scale = max(np.linalg.norm(a), 1e-30)
        recon = np.linalg.norm(
            a[:, np.asarray(perm)] - np.asarray(Q) @ np.asarray(R)
        )
        assert recon / scale < 1e-5
        assert numerical_rank(R) == true_rank


def test_pivoted_qr_zero_matrix():
    a = np.zeros((8, 5), np.float32)
    Q, R, perm = pivoted_qr(a)
    assert numerical_rank(R) == 0
    assert np.allclose(np.asarray(R), 0.0)
    # Q still orthonormal (identity columns)
    assert np.max(np.abs(np.asarray(Q).T @ np.asarray(Q) - np.eye(5))) < 1e-6


def test_pivoted_qtb_matches_explicit():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((40, 24)).astype(np.float32)
    b = rng.standard_normal((40, 2)).astype(np.float32)
    R, qtb, perm = pivoted_qr_qtb(a, b)
    Q, R2, perm2 = pivoted_qr(a, mode="reduced")
    np.testing.assert_array_equal(np.asarray(perm), np.asarray(perm2))
    np.testing.assert_allclose(np.asarray(R), np.asarray(R2), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(qtb)[:24], np.asarray(Q).T @ b, atol=1e-4
    )


def test_lstsq_pivoted_full_rank_matches_plain():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((60, 20)).astype(np.float32)
    xt = rng.standard_normal(20).astype(np.float32)
    b = a @ xt
    x = np.asarray(lstsq_pivoted(a, b))
    np.testing.assert_allclose(x, xt, atol=1e-3)


def test_lstsq_pivoted_min_norm_rank_deficient():
    """Exactly-duplicated columns: plain QR back-substitution divides by a
    ~0 pivot; the pivoted path must return the MIN-NORM solution
    (np.linalg.lstsq parity — residual equal AND ||x|| minimal)."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal((50, 6)).astype(np.float32)
    a = np.concatenate([base, base[:, :3]], axis=1)  # rank 6, n = 9
    b = rng.standard_normal(50).astype(np.float32)
    x = np.asarray(lstsq_pivoted(a, b))
    x_ref, *_ = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                                rcond=None)
    r_ours = np.linalg.norm(a @ x - b)
    r_ref = np.linalg.norm(a @ x_ref - b)
    assert abs(r_ours - r_ref) < 1e-3 * (1 + r_ref)
    # min-norm: matches lstsq's x (unique among minimal-residual solutions)
    np.testing.assert_allclose(x, x_ref, atol=5e-3)


def test_lstsq_auto_reroutes_on_rank_deficiency():
    """The public lstsq detects diagonal decay and transparently takes the
    pivoted min-norm path (round-2 VERDICT item 3 'Done' criterion)."""
    rng = np.random.default_rng(6)
    base = rng.standard_normal((64, 8)).astype(np.float32)
    # power-of-two multipliers keep the dependency EXACT in fp32, so the
    # float64 oracle sees the same rank-8 matrix.
    a = np.concatenate([base, base[:, :4] @ np.diag(
        np.float32([1, 2, 4, 0.5]))], axis=1)  # rank 8, n = 12
    b = rng.standard_normal(64).astype(np.float32)
    x = np.asarray(lstsq(a, b, block_size=4))
    assert np.isfinite(x).all()
    x_ref, *_ = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                                rcond=1e-6)
    r_ours = np.linalg.norm(a @ x - b)
    r_ref = np.linalg.norm(a @ x_ref - b)
    assert abs(r_ours - r_ref) < 1e-3 * (1 + r_ref)
    np.testing.assert_allclose(x, x_ref, atol=5e-3)


def test_lstsq_rcond_zero_disables_rerouting():
    # Full-rank system: rcond=0 path must behave exactly like before.
    rng = np.random.default_rng(7)
    a = rng.standard_normal((48, 16)).astype(np.float32)
    xt = rng.standard_normal(16).astype(np.float32)
    b = a @ xt
    x = np.asarray(lstsq(a, b, rcond=0))
    np.testing.assert_allclose(x, xt, atol=1e-3)


def test_pivoted_qr_complete_mode():
    a = np.random.default_rng(8).standard_normal((20, 12)).astype(np.float32)
    Q, R, perm = pivoted_qr(a, mode="complete")
    assert Q.shape == (20, 20) and R.shape == (20, 12)
    assert np.max(np.abs(np.asarray(Q).T @ np.asarray(Q) - np.eye(20))) < 2e-5
    recon = np.linalg.norm(a[:, np.asarray(perm)] - np.asarray(Q) @ np.asarray(R))
    assert recon / np.linalg.norm(a) < 2e-5


# ---------------------------------------------------------------------------
# RQRCP tier (randomized sketch pivoting, Duersch & Gu 2017): the blocked
# pivoted QR.  Pivots are sketch-greedy (same rank-revealing
# class as QP3, not bit-identical pivots), so these tests assert the
# factorization CONTRACT (exact reconstruction, orthonormal Q, valid
# permutation, running-max diagonal decay, rank detection) rather than
# scipy pivot parity.
# ---------------------------------------------------------------------------


def _check_rqrcp(a, block_size=128, rtol=5e-6):
    Q, R, perm = pivoted_qr(a, mode="reduced", method="rqrcp",
                            block_size=block_size)
    Q, R, perm = np.asarray(Q), np.asarray(R), np.asarray(perm)
    m, n = a.shape
    k = min(m, n)
    scale = max(np.linalg.norm(a), 1e-30)
    assert np.linalg.norm(a[:, perm] - Q @ R) / scale < rtol
    assert np.max(np.abs(Q.T @ Q - np.eye(k))) < rtol
    assert sorted(perm.tolist()) == list(range(n))
    # sketch-greedy decay: no diagonal entry exceeds the running max of
    # its predecessors by more than the sketch distortion allows
    d = np.abs(np.diag(R))
    runmax = np.maximum.accumulate(d)[:-1]
    assert np.all(d[1:] <= 1.3 * runmax + rtol * (d[0] + 1e-30))
    return Q, R, perm


def test_rqrcp_full_rank():
    rng = np.random.default_rng(0)
    _check_rqrcp(rng.standard_normal((640, 512)).astype(np.float32))
    _check_rqrcp(rng.standard_normal((512, 512)).astype(np.float32))


def test_rqrcp_graded_columns_rank_parity():
    rng = np.random.default_rng(1)
    a = (rng.standard_normal((512, 512)) * np.logspace(0, -8, 512)).astype(
        np.float32
    )
    # 8 decades of column grading: fp32 orthogonality accumulates to
    # ~6e-6 — use the exact path's tolerance (_check_pivoted's 2e-5).
    _, R, _ = _check_rqrcp(a, rtol=2e-5)
    _, Rs, _ = scipy.linalg.qr(a.astype(np.float64), pivoting=True)
    # same numerical rank as the exact pivoted factorization
    r_ours = numerical_rank(R, m=512)
    d = np.abs(np.diag(Rs))
    cut = np.finfo(np.float32).eps * 512 * d[0]
    r_scipy = int(np.sum(d > cut))
    assert abs(r_ours - r_scipy) <= 2, (r_ours, r_scipy)


def test_rqrcp_lowrank_rank_detection():
    rng = np.random.default_rng(2)
    a = (
        rng.standard_normal((640, 100)) @ rng.standard_normal((100, 512))
    ).astype(np.float32)
    Q, R, perm = _check_rqrcp(a)
    assert numerical_rank(R, m=640) == 100


def test_rqrcp_exactly_singular_falls_back_to_exact():
    """Exactly-zero trailing panels make the NS panel chains poison; the
    public wrapper must transparently retry via the exact QP3 path and
    still return a correct rank-revealing factorization."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((512, 512)).astype(np.float32)
    a[:, 100] = 0.0
    a[:, 200] = a[:, 50]
    a[:, 300:] = 0.0  # rank = 300 - 2
    Q, R, perm = _check_rqrcp(a)
    assert numerical_rank(R, m=512) == 298


def test_rqrcp_qtb_solve_matches_numpy():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((640, 512)).astype(np.float32)
    b = rng.standard_normal((640,)).astype(np.float32)
    R, qtb, perm = pivoted_qr_qtb(a, b, method="rqrcp", block_size=128)
    R = np.asarray(R, np.float64)
    qtb = np.asarray(qtb, np.float64)
    perm = np.asarray(perm)
    xp = scipy.linalg.solve_triangular(R[:512, :512], qtb[:512])
    x = np.empty(512)
    x[perm] = xp
    x_np = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                           rcond=None)[0]
    assert np.linalg.norm(x - x_np) / np.linalg.norm(x_np) < 1e-5


def test_rqrcp_shape_guards():
    a = np.random.default_rng(5).standard_normal((96, 100)).astype(
        np.float32
    )
    with pytest.raises(ValueError):
        pivoted_qr(a, method="rqrcp", block_size=128)  # m < n, r !| n
    with pytest.raises(ValueError):
        pivoted_qr(
            np.ones((256, 256), np.float32), mode="complete",
            method="rqrcp", block_size=64,
        )


def test_rqrcp_deterministic_given_seed():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((512, 512)).astype(np.float32)
    _, R1, p1 = pivoted_qr(a, mode="reduced", method="rqrcp", seed=7)
    _, R2, p2 = pivoted_qr(a, mode="reduced", method="rqrcp", seed=7)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    np.testing.assert_array_equal(np.asarray(R1), np.asarray(R2))


def _greedy_qrcp_oracle(B, r):
    """Float64 greedy QRCP selection by explicit re-orthogonalization (no
    norm downdates): at each step the unselected column of largest
    residual norm, then a full Gram-Schmidt projection of every column."""
    B = np.asarray(B, np.float64).copy()
    w = B.shape[1]
    selected = np.zeros(w, bool)
    sel, ds = [], []
    for _ in range(r):
        norms = np.where(selected, -np.inf, np.sum(B * B, axis=0))
        j = int(np.argmax(norms))
        q = B[:, j].copy()
        nq = np.linalg.norm(q)
        sel.append(j)
        ds.append(nq)
        selected[j] = True
        if nq > 0:
            q /= nq
            B -= np.outer(q, q @ B)
    return np.array(sel), np.array(ds)


@pytest.mark.parametrize("d,w,r", [(24, 256, 16), (40, 300, 32),
                                   (136, 500, 128)])
def test_sketch_qrcp_matches_numpy_greedy(d, w, r):
    """_sketch_qrcp (the XLA selection loop the RQRCP tier runs) picks the
    greedy QRCP pivots in order, with their residual norms, on column
    scales spread over several orders of magnitude — checked against a
    float64 oracle for as long as the oracle's own choice is unambiguous
    (a near-tie in residual norm may legitimately go either way in fp32)."""
    from mixedprecisionblockqr_tpu.ops.pivoted import _sketch_qrcp

    rng = np.random.default_rng(d + w)
    a = rng.standard_normal((d, w)).astype(np.float32)
    a = a * np.exp(rng.standard_normal(w)).astype(np.float32)
    sel, ds = _sketch_qrcp(jnp.asarray(a), r)
    sel, ds = np.asarray(sel), np.asarray(ds)
    ref_sel, ref_ds = _greedy_qrcp_oracle(a, r)
    assert len(set(sel.tolist())) == r
    # Compare the prefix on which the oracle's argmax has a clear margin.
    Bo = np.asarray(a, np.float64).copy()
    selected = np.zeros(w, bool)
    for s in range(r):
        norms = np.where(selected, -np.inf, np.sum(Bo * Bo, axis=0))
        top2 = np.sort(norms)[-2:]
        if top2[1] - top2[0] < 1e-3 * top2[1]:
            break
        assert sel[s] == ref_sel[s], (s, sel[:s + 1], ref_sel[:s + 1])
        np.testing.assert_allclose(ds[s], ref_ds[s], rtol=1e-3)
        j = ref_sel[s]
        q = Bo[:, j] / np.linalg.norm(Bo[:, j])
        Bo -= np.outer(q, q @ Bo)
        selected[j] = True
    assert s >= min(r, 8) - 1, f"oracle margin vanished after {s} steps"


def test_sketch_qrcp_zero_and_duplicate_columns():
    """A zero column is never an early pivot, and a duplicate of an
    already-selected column has zero residual and is not re-picked while
    live columns remain."""
    from mixedprecisionblockqr_tpu.ops.pivoted import _sketch_qrcp

    rng = np.random.default_rng(1)
    a = rng.standard_normal((24, 256)).astype(np.float32)
    a[:, 10] = 0.0
    a[:, 30] = 10.0 * a[:, 20]  # dominant: picked first
    a[:, 20] = a[:, 30]
    sel, ds = _sketch_qrcp(jnp.asarray(a), 16)
    sel = np.asarray(sel)
    assert len(set(sel.tolist())) == 16
    assert 10 not in sel
    assert sel[0] in (20, 30)
    assert not ({20, 30} <= set(sel.tolist()))  # the twin is never re-picked
    ref_sel, _ = _greedy_qrcp_oracle(a, 1)
    assert ref_sel[0] in (20, 30)


def test_pivoted_qr_jit_traceable_auto():
    """Review finding (round 8): method='auto' under jax.jit must stay
    traceable — the rqrcp host-fetch fallback cannot run in-trace, so
    auto resolves to the exact tier there (pre-rqrcp behavior)."""
    import jax

    a = np.random.default_rng(9).standard_normal((512, 512)).astype(
        np.float32
    )
    Q, R, perm = jax.jit(pivoted_qr)(a)  # raised TracerBoolConversionError
    Q, R, perm = np.asarray(Q), np.asarray(R), np.asarray(perm)
    assert np.linalg.norm(a[:, perm] - Q @ R) / np.linalg.norm(a) < 2e-5


def test_pivoted_qr_jit_rqrcp_defer_poisons():
    """Explicit rqrcp inside jit takes defer semantics: an
    exactly-singular trailing block NaN-poisons the outputs instead of
    silently returning garbage (no host retry is possible in-trace)."""
    import jax
    from functools import partial

    a = np.random.default_rng(10).standard_normal((512, 512)).astype(
        np.float32
    )
    a[:, 300:] = 0.0
    fn = jax.jit(partial(pivoted_qr, mode="r", method="rqrcp"))
    R, perm = fn(a)
    assert not np.isfinite(np.asarray(R)[0, 0])


def test_numerical_rank_keys_on_max_diagonal():
    """Review finding (round 8): RQRCP's sketch-greedy order can put
    d[0] below the true max diagonal; the cutoff must key on max|d| so
    near-cutoff rows are judged against the same threshold as the exact
    tier's."""
    d = np.zeros((4, 4), np.float32)
    np.fill_diagonal(d, [0.8, 1.0, 0.5, 1.1e-6])
    # d[0]-keyed cutoff (eps*4*0.8) would count the 1.1e-6 entry OUT with
    # max-keyed too -- use a value straddling the two thresholds:
    eps = np.finfo(np.float32).eps
    np.fill_diagonal(d, [0.8, 1.0, 0.5, eps * 4 * 0.9])
    # max-keyed threshold = eps*4*1.0 > the entry -> rank 3;
    # a d[0]-keyed threshold (eps*4*0.8) would have counted it -> 4.
    assert numerical_rank(d) == 3
