"""Triangular-NS chain kernel (ops/pallas/ns.py) vs its plain-XLA twin
(ops/polar.py::tri_chain) — interpret mode on CPU, the reference's
kernel-vs-host-twin pattern (SURVEY §4.1) — plus the platform's choice of
chain and the drivers that run it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mixedprecisionblockqr_tpu.ops import blockqr
from mixedprecisionblockqr_tpu.ops.blockqr import _block_qr_bgs, chain_for
from mixedprecisionblockqr_tpu.ops.pallas import ns
from mixedprecisionblockqr_tpu.ops.pallas.ns import kernel_fits, ns_chain
from mixedprecisionblockqr_tpu.ops.policy import POLICY_FP32
from mixedprecisionblockqr_tpu.ops.polar import (
    tri_chain,
    tri_cholqr_robust,
    tri_inv_chol,
    tri_robust_panel,
)

_HI = jax.lax.Precision.HIGHEST


@pytest.mark.parametrize("r,iters", [(32, 6), (64, 6), (64, 10), (16, 8)])
def test_ns_chain_matches_tri_inv_chol(r, iters):
    rng = np.random.default_rng(r + iters)
    P = rng.standard_normal((8 * r, r)).astype(np.float32)
    G = jnp.asarray(P.T @ P)
    X_ref = tri_inv_chol(G, iters=iters)
    X, t, resid = ns_chain(G, iters=iters, interpret=True)
    # Same update, same seed, same guard; the kernel's products drop the
    # lo*lo term of the TF32 split (~2^-20 relative).
    np.testing.assert_allclose(np.asarray(X), np.asarray(X_ref),
                               rtol=1e-6, atol=1e-6)
    # t = triu(X^T G) is the exact inverse of X at convergence.
    np.testing.assert_allclose(
        np.asarray(jnp.matmul(X, t, precision=_HI)), np.eye(r), atol=5e-4,
    )
    assert float(resid) < 1e-4
    # X upper-triangular, t upper-triangular.
    assert np.allclose(np.tril(np.asarray(X), -1), 0.0)
    assert np.allclose(np.tril(np.asarray(t), -1), 0.0)


def test_ns_chain_shift_mode():
    # Shifted pass: converges on a near-singular Gram where the unshifted
    # chain's budget would blow; t stays the exact inverse of X w.r.t. the
    # SHIFTED Gram, so reconstruction through (P X) t is preserved.
    rng = np.random.default_rng(5)
    U, _ = np.linalg.qr(rng.standard_normal((64, 64)))
    P = (U * np.logspace(0, -5, 64)).astype(np.float32)
    G = jnp.asarray(P.T @ P)
    X, t, resid = ns_chain(G, iters=14, shift=1e-3, interpret=True)
    assert float(resid) < 1e-3
    np.testing.assert_allclose(
        np.asarray(jnp.matmul(X, t, precision=_HI)), np.eye(64), atol=1e-3,
    )


@pytest.mark.parametrize("iters", [1, 2, 3, 4, 8])
def test_ns_chain_iteration_sweep_matches_tri_chain(iters):
    # Every chain length — including the ones that stop mid-escape, where
    # any divergence in the seed, guard or over-relaxation schedule shows
    # before convergence can hide it — lands on the plain twin's X, t and
    # residual to fp32-roundoff class.
    r = 64
    rng = np.random.default_rng(100 + iters)
    P = rng.standard_normal((8 * r, r)).astype(np.float32)
    G = jnp.asarray(P.T @ P)
    X, t, resid = ns_chain(G, iters=iters, interpret=True)
    Xc, tc, residc = tri_chain(G, iters)
    np.testing.assert_allclose(np.asarray(X), np.asarray(Xc),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np.asarray(t), np.asarray(tc),
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(float(resid), float(residc),
                               rtol=1e-3, atol=1e-6)
    if iters >= 8:
        assert float(resid) < 1e-4 and float(residc) < 1e-4


def test_ns_chain_refine_mode():
    # Identity-seeded refinement on a Gram near I (pass-2/3 use).
    rng = np.random.default_rng(6)
    E = rng.standard_normal((64, 64)).astype(np.float32)
    G = jnp.asarray(np.eye(64, dtype=np.float32) + 1e-3 * (E + E.T))
    X, t, resid = ns_chain(G, iters=4, refine=True, interpret=True)
    M = np.asarray(
        jnp.matmul(X.T, jnp.matmul(G, X, precision=_HI), precision=_HI)
    )
    assert np.max(np.abs(M - np.eye(64))) < 1e-6
    # refine chains report the exact post-loop residual
    assert float(resid) < 1e-6


def test_split_tf32_is_exact():
    a = jnp.asarray(np.random.default_rng(1).standard_normal((64, 64)),
                    jnp.float32)
    hi, lo = ns._split_tf32(a)
    bits = np.asarray(jax.lax.bitcast_convert_type(hi, jnp.int32))
    assert not np.any(bits & 0x1FFF)  # hi fits TF32's 10 mantissa bits
    np.testing.assert_array_equal(np.asarray(hi + lo), np.asarray(a))
    assert float(jnp.max(jnp.abs(lo) / jnp.abs(a))) <= 2.0 ** -10


@pytest.mark.parametrize("transpose_a", [False, True])
def test_dot3_is_fp32_class(transpose_a):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((128, 128)).astype(np.float32)
    b = rng.standard_normal((128, 128)).astype(np.float32)
    if transpose_a:
        got = np.asarray(ns._dot_ta(jnp.asarray(a), jnp.asarray(b),
                                    emulate=True))
        ref = a.astype(np.float64).T @ b.astype(np.float64)
    else:
        got = np.asarray(ns._dot(jnp.asarray(a), jnp.asarray(b),
                                 emulate=True))
        ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).max() * np.abs(b).max() * 128
    assert np.max(np.abs(got - ref)) / scale < 2.0 ** -20


@pytest.mark.parametrize("r,fits", [
    (8, False), (16, True), (32, True), (48, False), (64, True),
    (128, False), (256, False),
])
def test_kernel_fits(r, fits):
    assert kernel_fits(r) is fits


def test_ns_chain_rejects_unsupported_width():
    with pytest.raises(ValueError, match="power-of-two"):
        ns_chain(jnp.eye(48, dtype=jnp.float32), iters=2, interpret=True)


@pytest.mark.parametrize("platform,r,kernel", [
    ("gpu", 64, True), ("gpu", 32, True), ("gpu", 128, False),
    ("gpu", 96, False), ("cpu", 64, False),
])
def test_chain_for_platform_choice(platform, r, kernel, monkeypatch):
    """The chain a platform gets: the kernel on a GPU at the widths it
    compiles, the plain twin everywhere else."""
    calls = []

    def fake_kernel(G, iters, shift=0.0, refine=False, omega=True):
        calls.append(G.shape[0])
        return tri_chain(G, iters, shift=shift, refine=refine, omega=omega)

    monkeypatch.setattr(ns, "ns_chain", fake_kernel)
    chain = chain_for(platform)
    G = jnp.eye(r, dtype=jnp.float32) * 2.0
    X, t, resid = chain(G, 3)
    assert calls == ([r] if kernel else [])
    np.testing.assert_allclose(np.asarray(X), np.eye(r) / np.sqrt(2.0),
                               rtol=1e-5)
    if platform == "cpu":
        assert chain is tri_chain


def _interpret_kernel(monkeypatch):
    kernel = ns.ns_chain

    def interpreted(G, iters, shift=0.0, refine=False, omega=True):
        return kernel(G, iters, shift=shift, refine=refine, omega=omega,
                      interpret=True)

    monkeypatch.setattr(ns, "ns_chain", interpreted)


@pytest.mark.parametrize("pm", ["bgs1", "bgs2", "bgs"])
def test_bgs_driver_kernel_chain_parity(pm, monkeypatch):
    """The full driver with the GPU chain (kernel in interpret mode) matches
    the plain chain — per-panel chains, robust tail and rescrub alike."""
    _interpret_kernel(monkeypatch)
    a = np.random.default_rng(0).standard_normal((256, 256)).astype(
        np.float32)
    out = {}
    for platform in ("cpu", "gpu"):
        R, Q, _ = _block_qr_bgs(
            jnp.asarray(a), 64, POLICY_FP32, True, None, 2, platform,
            reorth=pm != "bgs1", mid_tier=pm == "bgs2")
        out[platform] = (np.asarray(R), np.asarray(Q))
    np.testing.assert_allclose(out["cpu"][0], out["gpu"][0], atol=1e-4)
    np.testing.assert_allclose(out["cpu"][1], out["gpu"][1], atol=1e-4)
    assert np.isfinite(out["gpu"][0][0, 0])


def _ill_conditioned_panel():
    rng = np.random.default_rng(4)
    U, _ = np.linalg.qr(rng.standard_normal((256, 64)))
    V, _ = np.linalg.qr(rng.standard_normal((64, 64)))
    return jnp.asarray((U * np.logspace(0, -4, 64)) @ V.T, dtype=jnp.float32)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_robust_panel_ill_conditioned(platform, monkeypatch):
    # cond(P) ~ 1e4: inside the documented fp32 Gram domain for the
    # three-pass scheme; quality class of the tri_cholqr_robust composition.
    _interpret_kernel(monkeypatch)
    P = _ill_conditioned_panel()
    Qf, tf, residf = tri_robust_panel(P, chain_for(platform))
    Qx, tx, _ = tri_cholqr_robust(P, sign_fix=False)
    # Edge-of-domain (cond 1e4) robust residual is ~1e-3-class — healthy
    # for this tier (breakdown is >= 1e-1; drivers scale robust resids by
    # 1e-2 against the shared 1e-4 poison threshold).
    assert float(residf) < 1e-2
    orth_f = float(jnp.max(jnp.abs(Qf.T @ Qf - jnp.eye(64))))
    orth_x = float(jnp.max(jnp.abs(Qx.T @ Qx - jnp.eye(64))))
    recon = float(jnp.max(jnp.abs(Qf @ tf - P)))
    assert orth_f < max(5e-5, 2 * orth_x)
    assert recon < 1e-4


def test_robust_panel_kernel_matches_plain(monkeypatch):
    _interpret_kernel(monkeypatch)
    P = _ill_conditioned_panel()
    Qg, tg, rg = tri_robust_panel(P, chain_for("gpu"))
    Qc, tc, rc = tri_robust_panel(P, chain_for("cpu"))
    np.testing.assert_allclose(np.asarray(Qg), np.asarray(Qc), atol=1e-4)
    np.testing.assert_allclose(np.asarray(tg), np.asarray(tc),
                               atol=1e-4 * float(jnp.max(jnp.abs(tc))))


def test_robust_tail_breakdown_trips_canary():
    """A cond ~1e9 matrix is far beyond the three-pass scheme's fp32 Gram
    domain: the robust tail chains must REPORT failure through the NaN
    canary (_poison_if_unconverged) instead of silently returning a garbage
    factorization."""
    rng = np.random.default_rng(13)
    n = 512
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = jnp.asarray((U * np.logspace(0, -9, n)) @ V.T, dtype=jnp.float32)
    R, Q, _ = jax.jit(
        lambda x: _block_qr_bgs(
            x, 128, POLICY_FP32, True, None, 4, "cpu", reorth=False,
        )
    )(A)
    assert not np.isfinite(np.asarray(R)[0, 0]), (
        "ill-conditioned tail panel must poison the output, not pass"
    )
    # And check='sync' turns the canary into a transparent retry through
    # the robust reflector tier (which may legitimately succeed or fail on
    # this matrix, but must return FINITE results or raise — here we only
    # require it not to return the poisoned buffers).  The default
    # check='defer' intentionally PROPAGATES the NaN instead (no blocking
    # fetch on the public path).
    Q2, R2 = blockqr.block_qr(A, block_size=128, policy=POLICY_FP32,
                              mode="complete", panel_method="bgs1",
                              check="sync")
    backward = float(
        jnp.linalg.norm(Q2 @ R2 - A) / jnp.linalg.norm(A)
    )
    assert np.isfinite(backward)


def test_bgs2_mid_tier_quality_ladder():
    """'bgs2': BCGS2 reorth with a 3-pass bf16 scrub + fp32 in-group dots —
    orthogonality must land strictly below bgs1 (panel-noise floor) and
    within reach of bgs (fp32 scrub)."""
    from mixedprecisionblockqr_tpu.ops.policy import POLICY_MIXED

    rng = np.random.default_rng(20)
    a = rng.standard_normal((512, 512)).astype(np.float32)
    A = jnp.asarray(a)
    orth = {}
    for pm, reorth, mid in (("bgs1", False, False), ("bgs2", True, True),
                            ("bgs", True, False)):
        R, Q, _ = jax.jit(
            lambda x, reorth=reorth, mid=mid: _block_qr_bgs(
                x, 128, POLICY_MIXED, True, None, 4, "cpu",
                reorth=reorth, mid_tier=mid,
            )
        )(A)
        Qn = np.asarray(Q, dtype=np.float64)
        orth[pm] = float(np.max(np.abs(Qn.T @ Qn - np.eye(512))))
        recon = np.linalg.norm(Qn @ np.asarray(R, np.float64) - a)
        assert recon / np.linalg.norm(a) < 0.02, (pm, recon)
    assert orth["bgs2"] < orth["bgs1"], orth
    assert orth["bgs"] <= orth["bgs2"] * 3, orth  # bgs stays the top tier


@pytest.mark.gpu
def test_ns_chain_compiled_on_gpu(gpu):
    """The compiled Triton kernel against the plain chain at HIGHEST."""
    rng = np.random.default_rng(0)
    P = rng.standard_normal((2048, 64)).astype(np.float32)
    G = jnp.asarray(P.T @ P)
    X, t, resid = ns_chain(G, iters=6)
    Xr, tr, rr = tri_chain(G, 6)
    np.testing.assert_allclose(np.asarray(X), np.asarray(Xr),
                               rtol=1e-5, atol=1e-6)
    assert float(resid) < 1e-4
