"""CholeskyQR2 panel path and the Yamamoto block reflector."""

import jax.numpy as jnp
import numpy as np
import pytest

from mixedprecisionblockqr_tpu.ops import metrics
from mixedprecisionblockqr_tpu.ops.blockqr import block_qr
from mixedprecisionblockqr_tpu.ops.cholqr import cholesky_qr2, yamamoto_reflector
from mixedprecisionblockqr_tpu.ops.policy import POLICY_MIXED
from mixedprecisionblockqr_tpu.utils.datagen import conditioned_matrix


def test_cholesky_qr2_orthogonality():
    P = np.random.default_rng(0).random((512, 64)).astype(np.float32)
    Q, R = cholesky_qr2(jnp.asarray(P))
    Qn = np.asarray(Q, np.float64)
    np.testing.assert_allclose(Qn.T @ Qn, np.eye(64), atol=1e-5)
    np.testing.assert_allclose(Qn @ np.asarray(R), P, atol=1e-4)
    assert np.allclose(np.tril(np.asarray(R), -1), 0.0)


def test_cholesky_qr2_shifted_handles_moderate_conditioning():
    A = conditioned_matrix(96, 2.5e3, seed=1).astype(np.float32)[:, :32]
    Q, R = cholesky_qr2(jnp.asarray(A), shifted=True)
    Qn = np.asarray(Q, np.float64)
    np.testing.assert_allclose(Qn.T @ Qn, np.eye(32), atol=1e-4)
    assert (
        np.linalg.norm(Qn @ np.asarray(R) - A) / np.linalg.norm(A) < 1e-5
    )


def test_yamamoto_reflector_identity():
    P = np.random.default_rng(2).random((96, 16)).astype(np.float32)
    Q, R = cholesky_qr2(jnp.asarray(P))
    Y, Sinv, Rf = yamamoto_reflector(Q, R)
    Yn, Sn = np.asarray(Y, np.float64), np.asarray(Sinv, np.float64)
    H = np.eye(96) - Yn @ Sn @ Yn.T
    np.testing.assert_allclose(H.T @ H, np.eye(96), atol=1e-5)  # orthogonal
    # H^T P == [R; 0] with the sign-fixed R.
    HtP = H.T @ P
    np.testing.assert_allclose(HtP[:16], np.asarray(Rf), atol=1e-4)
    np.testing.assert_allclose(HtP[16:], 0.0, atol=1e-4)


@pytest.mark.parametrize("pm", ["cholqr2", "cholqr2s"])
def test_block_qr_cholqr_panels(pm):
    A = np.random.default_rng(3).random((192, 128)).astype(np.float32) - 0.5
    Q, R = block_qr(A, block_size=32, mode="complete", panel_method=pm)
    rep = metrics.evaluate(A, Q, R, precision_bits=23)
    assert rep.all_ok, f"{pm}: {rep}"


def test_block_qr_cholqr_mixed():
    A = np.random.default_rng(4).random((256, 192)).astype(np.float32) - 0.5
    Q, R = block_qr(A, block_size=64, policy=POLICY_MIXED, mode="complete",
                    panel_method="cholqr2")
    rep = metrics.evaluate(A, Q, R, precision_bits=8)
    assert rep.all_ok, str(rep)


def test_block_qr_cholqr1_mixed():
    A = np.random.default_rng(5).random((256, 192)).astype(np.float32) - 0.5
    Q, R = block_qr(A, block_size=64, policy=POLICY_MIXED, mode="complete",
                    panel_method="cholqr1")
    rep = metrics.evaluate(A, Q, R, precision_bits=8)
    assert rep.all_ok, str(rep)


def test_newton_inv_matches_lu():
    from mixedprecisionblockqr_tpu.ops.cholqr import newton_inv

    P = np.random.default_rng(6).random((64, 16)).astype(np.float32)
    Q, R = cholesky_qr2(jnp.asarray(P))
    _, Sinv_lu, _ = yamamoto_reflector(Q, R, inv_method="lu")
    _, Sinv_nw, _ = yamamoto_reflector(Q, R, inv_method="newton")
    np.testing.assert_allclose(
        np.asarray(Sinv_nw), np.asarray(Sinv_lu), atol=1e-4
    )


def test_cholqr_square_matrix_hybrid():
    """Square matrices: the final panel is square/ill-conditioned — the
    hybrid rule must route it to the Householder panel so CholeskyQR
    methods stay accurate (regression for a square-sweep blow-up)."""
    A = np.random.default_rng(8).random((256, 256)).astype(np.float32) - 0.5
    for pm in ("cholqr1", "cholqr2"):
        Q, R = block_qr(A, block_size=128, policy=POLICY_MIXED,
                        mode="complete", panel_method=pm)
        rep = metrics.evaluate(A, Q, R, precision_bits=8)
        assert rep.backward < 0.05, (pm, str(rep))
        assert rep.all_ok, (pm, str(rep))


def test_block_qr_cholqr1x2_paired_panels():
    """Paired-panel method: two cholqr1 reflectors merged into one 2r-wide
    block reflector; quality must match cholqr1."""
    A = np.random.default_rng(9).random((384, 256)).astype(np.float32) - 0.5
    Q, R = block_qr(A, block_size=64, policy=POLICY_MIXED, mode="complete",
                    panel_method="cholqr1x2")
    rep = metrics.evaluate(A, Q, R, precision_bits=8)
    assert rep.all_ok, str(rep)
