"""Triangular Newton-Schulz inverse Cholesky + symmetric isqrt
(ops/polar.py) — the custom-call-free panel factorization of the grouped
driver, oracle-tested against chol/eigh."""

import jax.numpy as jnp
import numpy as np
import pytest

from mixedprecisionblockqr_tpu.ops.polar import ns_isqrt, tri_cholqr, tri_inv_chol


def _spd(r, cond, seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((r, r)))
    vals = np.geomspace(1.0, cond, r)
    return (q * vals) @ q.T


@pytest.mark.parametrize("r,cond", [(32, 10), (64, 100), (128, 300)])
def test_tri_inv_chol_matches_cholesky(r, cond):
    G = _spd(r, cond).astype(np.float32)
    X = np.asarray(tri_inv_chol(jnp.asarray(G), iters=14), np.float64)
    # upper triangular
    assert np.abs(np.tril(X, -1)).max() == 0.0
    # X^T G X = I
    resid = np.abs(X.T @ G.astype(np.float64) @ X - np.eye(r)).max()
    assert resid < 5e-5, resid
    # matches chol(G)^{-1} up to fp32 class
    ref = np.linalg.inv(np.linalg.cholesky(G.astype(np.float64)).T)
    assert np.abs(X - ref).max() / np.abs(ref).max() < 1e-3


def test_tri_cholqr_panel():
    rng = np.random.default_rng(1)
    P = rng.standard_normal((512, 64)).astype(np.float32)
    Qs, t, X = tri_cholqr(jnp.asarray(P), iters=10)
    Qn, tn = np.asarray(Qs, np.float64), np.asarray(t, np.float64)
    # orthonormal, sign convention, triangular t, reconstruction
    assert np.abs(Qn.T @ Qn - np.eye(64)).max() < 5e-6
    assert (np.diag(Qn[:64]) <= 0).all()
    assert np.abs(np.tril(tn, -1)).max() == 0.0
    assert np.linalg.norm(P - Qn @ tn) / np.linalg.norm(P) < 5e-6
    # X is the inverse factor: Qs = P X
    np.testing.assert_allclose(
        np.asarray(jnp.matmul(jnp.asarray(P), X)), np.asarray(Qs), atol=1e-5
    )


def test_tri_cholqr_refined_ill_conditioned():
    # cond(G) ~ 1e5-class square block (the driver's tail-panel regime):
    # the refinement pass must reach fp32-roundoff-class orthogonality,
    # like CholeskyQR2.
    rng = np.random.default_rng(2)
    A = rng.standard_normal((2048, 2048))
    blk = np.linalg.qr(A, mode="r")[1920:, 1920:].astype(np.float32)
    Qs, t, _ = tri_cholqr(jnp.asarray(blk), iters=24, refine_iters=6)
    Qn = np.asarray(Qs, np.float64)
    assert np.abs(Qn.T @ Qn - np.eye(128)).max() < 5e-5
    back = np.linalg.norm(blk - Qn @ np.asarray(t, np.float64))
    assert back / np.linalg.norm(blk) < 1e-5


@pytest.mark.parametrize("r,cond", [(32, 10), (96, 200)])
def test_ns_isqrt_matches_eigh(r, cond):
    G = _spd(r, cond, seed=3)
    N = np.asarray(ns_isqrt(jnp.asarray(G.astype(np.float32)), iters=14),
                   np.float64)
    w, v = np.linalg.eigh(G)
    ref = (v / np.sqrt(w)) @ v.T
    assert np.abs(N - ref).max() / np.abs(ref).max() < 1e-3
    assert np.abs(N @ G @ N - np.eye(r)).max() < 5e-5


def test_blockqr_polar_method_quality():
    from mixedprecisionblockqr_tpu.ops import metrics
    from mixedprecisionblockqr_tpu.ops.blockqr import block_qr
    from mixedprecisionblockqr_tpu.ops.policy import POLICY_FP32, POLICY_MIXED

    rng = np.random.default_rng(4)
    A = rng.standard_normal((512, 512)).astype(np.float32)
    for g in (1, 4):
        Q, R = block_qr(A, block_size=64, policy=POLICY_FP32,
                        mode="complete", panel_method="polar",
                        group_panels=g)
        rep = metrics.evaluate(A, Q, R, precision_bits=23)
        # Fast-path quality class is cond^2*eps (like cholqr1), a few x
        # above the eps*sqrt(m) tight gate at small m — assert the
        # acceptance criterion plus an explicit 8e-5 cap instead.
        assert rep.all_ok, (g, str(rep))
        assert rep.orthogonality < 8e-5 and rep.backward < 8e-5, (g, str(rep))
    # mixed policy + rectangular + qtb path
    A = rng.standard_normal((768, 512)).astype(np.float32)
    Q, R = block_qr(A, block_size=128, policy=POLICY_MIXED, mode="complete",
                    panel_method="polar")
    rep = metrics.evaluate(A, Q, R, precision_bits=8)
    assert rep.all_ok and rep.tight_ok, str(rep)


def test_blockqr_polar_lstsq_path():
    from mixedprecisionblockqr_tpu.ops.blockqr import block_qr_qtb
    from mixedprecisionblockqr_tpu.models.lstsq import back_substitution
    from mixedprecisionblockqr_tpu.ops.policy import POLICY_FP32

    rng = np.random.default_rng(5)
    A = rng.standard_normal((640, 512)).astype(np.float32)
    xt = rng.standard_normal(512).astype(np.float32)
    b = A @ xt
    R, qtb = block_qr_qtb(A, b, block_size=64, policy=POLICY_FP32,
                          panel_method="polar")
    x = np.asarray(back_substitution(R, qtb[:512]))
    np.testing.assert_allclose(x, xt, atol=5e-3)


def test_blockqr_polar_fallback_on_indivisible():
    # n not a multiple of block_size -> silently falls back to cholqr1.
    from mixedprecisionblockqr_tpu.ops import metrics
    from mixedprecisionblockqr_tpu.ops.blockqr import block_qr

    A = np.random.default_rng(6).standard_normal((200, 120)).astype(np.float32)
    Q, R = block_qr(A, block_size=64, mode="complete", panel_method="polar")
    rep = metrics.evaluate(A, Q, R, precision_bits=23)
    assert rep.all_ok, str(rep)
