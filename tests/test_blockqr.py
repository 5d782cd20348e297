"""Blocked WY QR (fp32 and mixed-precision) — integration tests with the
reference's metric-threshold criteria (SURVEY §4.2): backward error,
orthogonality, and lower-trapezoid norm each bounded by 2^-bits * m
(23 bits fp32 — ``Cuda/qr.cu:1367``; 8 bits for the bf16 mixed path, the
recalibration of the reference's 11-bit fp16 bound ``Cuda/qr.cu:1889``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mixedprecisionblockqr_tpu.ops import metrics
from mixedprecisionblockqr_tpu.ops.blockqr import (
    block_qr,
    block_qr_qtb,
    block_recursive_qr,
    qr,
)
from mixedprecisionblockqr_tpu.ops.policy import POLICY_BF16, POLICY_FP32, POLICY_MIXED

# Subset of the reference's static size table (Cuda/qr.cu:1762-1787),
# including the non-tile-multiple shapes (97x90, 129x80).
SIZES = [
    (6, 4, 2),
    (12, 8, 4),
    (24, 16, 8),
    (60, 40, 16),
    (97, 90, 16),
    (129, 80, 16),
    (240, 160, 32),
]


def _rand(m, n, seed=0):
    return np.random.default_rng(seed).random((m, n)).astype(np.float32)


@pytest.mark.parametrize("m,n,r", SIZES)
def test_block_qr_fp32_criteria(m, n, r):
    A = _rand(m, n, seed=m + n)
    Q, R = block_qr(A, block_size=r, policy=POLICY_FP32, mode="complete")
    rep = metrics.evaluate(A, Q, R, precision_bits=23)
    assert rep.all_ok, f"{m}x{n} r={r}: {rep}"


def test_block_qr_matches_unblocked():
    A = _rand(96, 64, seed=7)
    Qb, Rb = block_qr(A, block_size=16)
    # Residual-level agreement (sign conventions may differ per column).
    err = float(metrics.backward_error(jnp.asarray(A), Qb, Rb))
    assert err < 1e-6
    Rn = np.linalg.qr(A)[1]
    np.testing.assert_allclose(
        np.abs(np.diag(np.asarray(Rb))), np.abs(np.diag(Rn)), rtol=1e-4
    )


def test_block_qr_mixed_precision_criteria():
    m, n = 256, 192
    A = _rand(m, n, seed=1)
    Q, R = block_qr(A, block_size=64, policy=POLICY_MIXED, mode="complete")
    rep = metrics.evaluate(A, Q, R, precision_bits=POLICY_MIXED.precision_bits)
    assert rep.all_ok, f"mixed: {rep}"
    # Mixed must be strictly worse than fp32 but within its own bound.
    Qf, Rf = block_qr(A, block_size=64, policy=POLICY_FP32, mode="complete")
    repf = metrics.evaluate(A, Qf, Rf, precision_bits=23)
    assert repf.backward < rep.backward


def test_bf16_no_nan_on_ill_conditioned():
    """The reference's fp16 study NaNs at cond >= 1e6
    (python/performance_test_result/error.md:15-16); bf16 keeps fp32's
    exponent range so the same matrices must stay finite."""
    from mixedprecisionblockqr_tpu.utils.datagen import conditioned_matrix

    A = conditioned_matrix(64, 1e6, seed=0).astype(np.float32)
    Q, R = block_qr(A, block_size=16, policy=POLICY_BF16, mode="complete")
    assert np.isfinite(np.asarray(Q)).all()
    assert np.isfinite(np.asarray(R)).all()
    rep = metrics.evaluate(A, Q, R, precision_bits=POLICY_BF16.precision_bits)
    assert rep.backward_ok, f"bf16 cond=1e6: {rep}"


def test_block_qr_qtb_threads_rhs():
    m, n = 80, 48
    A = _rand(m, n, seed=3)
    b = np.random.default_rng(4).random((m,)).astype(np.float32)
    R, qtb = block_qr_qtb(A, b, block_size=16)
    Q, Rq = block_qr(A, block_size=16, mode="complete")
    np.testing.assert_allclose(np.asarray(R), np.asarray(Rq)[:n], atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(qtb), np.asarray(Q).T @ b, atol=1e-3
    )


def test_block_recursive_qr():
    A = _rand(100, 64, seed=5)
    Q, R = block_recursive_qr(A, min_block=16)
    assert Q.shape == (100, 64) and R.shape == (64, 64)
    err = float(metrics.backward_error(jnp.asarray(A), Q, R))
    assert err < 1e-6
    assert float(metrics.orthogonality_error(Q)) < 1e-5


def test_qr_dispatcher():
    A = _rand(40, 6, seed=6)
    Q, R = qr(A)
    assert Q.shape == (40, 6)
    assert float(metrics.backward_error(jnp.asarray(A), Q, R)) < 1e-6
    # Wide matrices route through the unblocked path (reference semantics).
    Aw = _rand(4, 8, seed=7)
    Qw, Rw = qr(Aw, mode="complete")
    assert Qw.shape == (4, 4) and Rw.shape == (4, 8)
    assert float(metrics.backward_error(jnp.asarray(Aw), Qw, Rw)) < 1e-6
    # block_qr itself still requires m >= n.
    with pytest.raises(ValueError):
        block_qr(Aw)


def test_block_qr_r_only_mode():
    A = _rand(64, 32, seed=8)
    R = block_qr(A, block_size=16, mode="r")
    Rn = np.linalg.qr(A)[1]
    np.testing.assert_allclose(
        np.abs(np.diag(np.asarray(R))), np.abs(np.diag(Rn)), rtol=1e-4
    )


def test_block_qr_fp64_policy():
    from mixedprecisionblockqr_tpu.ops.policy import POLICY_FP64

    A = _rand(64, 48, seed=9).astype(np.float64)
    Q, R = block_qr(A, block_size=16, policy=POLICY_FP64, mode="complete")
    assert Q.dtype == jnp.float64
    QR = np.asarray(Q, np.float64) @ np.asarray(R, np.float64)
    err = np.linalg.norm(A - QR) / np.linalg.norm(A)
    assert err < 1e-13, err


def test_mixed_fast_bf16_q_store():
    from mixedprecisionblockqr_tpu.ops.policy import POLICY_MIXED_FAST

    A = _rand(128, 96, seed=10)
    Q, R = block_qr(A, block_size=32, policy=POLICY_MIXED_FAST,
                    mode="complete", panel_method="cholqr1")
    assert Q.dtype == jnp.bfloat16
    rep = metrics.evaluate(A, Q, R, precision_bits=8)
    assert rep.all_ok, str(rep)


def test_reorth_tiers_return_fp32_q_under_compact_policy():
    """Q-dtype contract (round-5c): the quality-ladder reorth tiers
    ('bgs'/'bgs2') return Q at ACCUMULATION precision even when the
    policy requests a compact bf16 Q residency — a bf16 return rounds
    every entry to 2^-9, pinning max|QtQ - I| at the bf16 STORAGE floor
    (~4.4e-4 at 2048, measured) no matter how precise the scrub was.
    The single-pass 'bgs1' tier keeps the compact residency (its
    HBM-traffic lever)."""
    from mixedprecisionblockqr_tpu.ops.policy import POLICY_MIXED_FAST

    A = _rand(256, 256, seed=11)
    for pm, lm in (("bgs", "unroll"), ("bgs2", "unroll"),
                   ("bgs", "scan"), ("bgs2", "scan")):
        Q, _ = block_qr(A, block_size=64, policy=POLICY_MIXED_FAST,
                        mode="complete", panel_method=pm, loop_mode=lm)
        assert Q.dtype == jnp.float32, (pm, lm, Q.dtype)
    Q, _ = block_qr(A, block_size=64, policy=POLICY_MIXED_FAST,
                    mode="complete", panel_method="bgs1")
    assert Q.dtype == jnp.bfloat16


def test_block_qr_scan_mode():
    """Single-chip scan mode: one fori_loop panel step + static Householder
    final panel; must match the unrolled path's quality."""
    A = _rand(256, 128, seed=11) - 0.5
    Qs, Rs = block_qr(A, block_size=32, policy=POLICY_MIXED, mode="complete",
                      panel_method="cholqr1", loop_mode="scan")
    rep = metrics.evaluate(A, Qs, Rs, precision_bits=8)
    assert rep.all_ok, str(rep)
    Ru = block_qr(A, block_size=32, policy=POLICY_MIXED, mode="r",
                  panel_method="cholqr1")
    np.testing.assert_allclose(
        np.abs(np.diag(np.asarray(Rs)[:128])),
        np.abs(np.diag(np.asarray(Ru))), rtol=2e-2,
    )


def test_block_qr_scan_fallback_to_unroll():
    # n not a multiple of r, or non-cholqr method -> silently unrolls.
    A = _rand(96, 60, seed=12)
    Q, R = block_qr(A, block_size=16, mode="complete",
                    panel_method="householder", loop_mode="scan")
    rep = metrics.evaluate(A, Q, R, precision_bits=23)
    assert rep.all_ok, str(rep)


def test_block_qr_differentiable():
    """The whole factorization is reverse-mode differentiable (static-shape
    fori_loops lower to scans) — a capability the reference's CUDA/host
    pipeline cannot offer at all."""
    import jax

    from mixedprecisionblockqr_tpu.ops.blockqr import _block_qr_traced

    A = jnp.asarray(_rand(24, 16, seed=13))

    def loss(x):
        R, Q, _ = _block_qr_traced(x, 8, POLICY_FP32, True, None, "householder")
        return jnp.sum(R[:16] ** 2) + jnp.sum(Q[:, :2] ** 2)

    g = jax.grad(loss)(A)
    assert bool(jnp.isfinite(g).all())
    eps = 1e-3
    E = jnp.zeros_like(A).at[3, 2].set(eps)
    fd = (loss(A + E) - loss(A - E)) / (2 * eps)
    np.testing.assert_allclose(float(g[3, 2]), float(fd), rtol=2e-2)


def test_block_qr_bgs_scan_mode():
    """Scan-mode BGS (_block_qr_bgs_scan): one compiled panel step,
    classical-GS projections against the Q buffer, robust NS panels —
    the compile-light path for 8192+."""
    from mixedprecisionblockqr_tpu.ops import metrics
    from mixedprecisionblockqr_tpu.ops.blockqr import block_qr

    a = _rand(512, 512, seed=21)
    Q, R = block_qr(jnp.asarray(a), 128, POLICY_FP32, mode="complete",
                    panel_method="bgs", loop_mode="scan")
    rep = metrics.evaluate(a, np.asarray(Q), np.asarray(R),
                           precision_bits=23)
    assert rep.all_ok, str(rep)
    # Rectangular reduced mode.
    a2 = _rand(640, 384, seed=22)
    Q2, R2 = block_qr(jnp.asarray(a2), 128, POLICY_FP32, mode="reduced",
                      panel_method="bgs1", loop_mode="scan")
    rep2 = metrics.evaluate(a2, np.asarray(Q2), np.asarray(R2),
                            precision_bits=23)
    # Acceptance criteria + an absolute orthogonality ceiling: the fp32
    # TIGHT gate (2^-23*sqrt(m) ~ 3e-6) sits below the NS-panel orth floor
    # (~1e-5) — that gate is calibrated for the mixed-policy bench config;
    # bgs is the throughput tier (see the quality ladder in PERF.md).
    assert rep2.all_ok and rep2.orthogonality < 1e-4, str(rep2)


def test_block_qr_bgs2_scan_grouped_kills_intergroup_drift():
    """'bgs2' in scan mode = grouped inter-group BCGS2: the double Qbuf
    pass before each group factors scrubs the single-pass CGS drift that
    grows with n/r (the 16384^2 fp32-criterion breaker) while KEEPING the
    group width —
    half the per-panel 'bgs' tier's Qbuf traffic.  Must beat bgs1's
    orthogonality on the same matrix and keep the grouped structure
    (same group_panels accepted)."""
    from mixedprecisionblockqr_tpu.ops import metrics
    from mixedprecisionblockqr_tpu.ops.blockqr import block_qr

    a = _rand(512, 512, seed=25)  # uncentered uniform: ill-conditioned
    orth = {}
    for pm in ("bgs1", "bgs2"):
        Q, R = block_qr(jnp.asarray(a), 64, POLICY_FP32, mode="complete",
                        panel_method=pm, loop_mode="scan", group_panels=4)
        rep = metrics.evaluate(a, np.asarray(Q), np.asarray(R),
                               precision_bits=23)
        assert rep.backward_ok and rep.lower_trapezoid_ok, f"{pm}: {rep}"
        orth[pm] = rep.orthogonality
        if pm == "bgs2":
            # The scrub restores the fp32 criterion bgs1 drifts past
            # (measured here: bgs1 ~3.8e-4 vs limit 6.1e-5; bgs2 ~1.0e-5).
            assert rep.all_ok, f"bgs2 must meet the fp32 criterion: {rep}"
    # The scrub must measurably beat single-pass inter-group CGS.
    assert orth["bgs2"] < 0.5 * orth["bgs1"], orth


def test_tail_rescrub_kills_corner_leak():
    """The reorth tiers' post-factorization rescrub (docs/ALGORITHMS.md
    D9): the group-start BCGS2
    scrub runs BEFORE factorization, and the ill-conditioned trailing
    corner amplifies its leftovers by ~kappa — every Q^T Q block sat at
    fp32 roundoff EXCEPT the robust tail panel's cross terms (~5e-5
    uniformly at 1024^2; extra NS iterations cannot move it).  The
    rescrub projects the FINISHED panel Q once more and refolds exactly
    (qk t = q2 (s t) + Qprev (W t)).  Pre-fix this 512^2 case measured
    orth 1.2e-5 unrolled / 3.8e-6 scan-bgs / 2.0e-5 scan-bgs2 — all past
    the 2^-23*sqrt(m) = 2.7e-6 tight gate; post-fix all reach ~1e-6."""
    a = _rand(512, 512, seed=0) - 0.5
    for pm, lm in (("bgs", "unroll"), ("bgs", "scan"), ("bgs2", "scan")):
        Q, R = block_qr(jnp.asarray(a), 128, POLICY_FP32, mode="complete",
                        panel_method=pm, loop_mode=lm, group_panels=4)
        rep = metrics.evaluate(a, np.asarray(Q), np.asarray(R),
                               precision_bits=23)
        assert rep.all_ok, f"{pm}/{lm}: {rep}"
        assert rep.tight_ok, (
            f"{pm}/{lm}: orth {rep.orthogonality:.2e} must meet the "
            f"fp32 tight gate (corner-leak rescrub regression)")


def test_tail_rescrub_covers_whole_robust_corner():
    """Scan-tier rescrub COVERAGE (round-5c review finding): the corner
    amplification spans the whole ill-conditioned tail (max(2, nb//8)
    panels), not just the final group — a final-step-only rescrub left
    the earlier tail panels' leaks in place whenever nb > 8g.  This
    config (nb=32, g=2 -> 16 steps, 4-panel tail across 2 steps) exercises
    exactly the previously-uncovered step on a Bierlaire-conditioned
    matrix whose corner kappa is large across several panels; the tight
    2^-23*sqrt(m) gate pins the fix."""
    from mixedprecisionblockqr_tpu.utils.datagen import conditioned_matrix

    a = conditioned_matrix(1024, condition_number=1e5, seed=3).astype(
        np.float32
    )
    for pm in ("bgs", "bgs2"):
        Q, R = block_qr(jnp.asarray(a), 32, POLICY_FP32, mode="complete",
                        panel_method=pm, loop_mode="scan", group_panels=2)
        rep = metrics.evaluate(a, np.asarray(Q), np.asarray(R),
                               precision_bits=23)
        assert rep.all_ok and rep.tight_ok, f"{pm}: {rep}"


def test_perpanel_fallback_matches_group_kernel_precision_contract():
    """The reorth tiers' precision contract ('ALL in-group dots HIGHEST'):
    eager in-group projections at mm_t (bf16 under mixed policies) floor
    orth at the in-group single-pass bf16 drift (~2^-11); with fp32
    in-group dots the per-panel driver reaches fp32-class orth under
    MIXED_FAST."""
    from mixedprecisionblockqr_tpu.ops.blockqr import _block_qr_bgs
    from mixedprecisionblockqr_tpu.ops.policy import POLICY_MIXED_FAST

    a = _rand(512, 512, seed=7) - 0.5
    R, Q, _ = _block_qr_bgs(
        jnp.asarray(a), 64, POLICY_MIXED_FAST, True, None,
        group_panels=4, reorth=True,
    )
    orth = float(metrics.orthogonality_error(np.asarray(Q, np.float32)))
    assert orth < 1e-5, (
        f"per-panel reorth fallback orth {orth:.2e} — bf16 eager "
        "projections leaked back into the reorth tier")


def test_block_qr_bgs_mixed_group_and_perpanel_groups():
    """Regression: a robust tail spanning TWO groups makes the first of
    them non-final, and its per-group trailing projection must concatenate
    exactly that group's panel Qs (indexing qcols by a stale panel offset
    crashed here)."""
    from mixedprecisionblockqr_tpu.ops import metrics
    from mixedprecisionblockqr_tpu.ops.blockqr import _block_qr_bgs

    # Centered uniform — the canary legitimately poisons the uncentered
    # rank-1-dominated draw here.
    a = _rand(3200, 768, seed=31) - 0.5
    # robust_tail=5 > group_panels=4: robust panels span groups 1 AND 2 of
    # nb=12 — group 1 has robust panels WITH trailing columns (the crash
    # site), group 2 is the final group.
    R_full, Q, _ = _block_qr_bgs(
        jnp.asarray(a), 64, POLICY_FP32, want_q=True, B=None,
        group_panels=4, reorth=False, robust_tail=5,
    )
    rep = metrics.evaluate(a, np.asarray(Q)[:, :768],
                           np.asarray(R_full)[:768], precision_bits=23)
    assert rep.backward_ok and rep.lower_trapezoid_ok, str(rep)


@pytest.mark.parametrize("pm", ["bgs", "bgs2"])
def test_block_qr_scan_reorth_mixed_policy_orth(pm):
    """SCAN-mode reorth tiers under MIXED policies deliver the unrolled
    ladder's class: Qbuf carries fp32 through the loop and every
    projection pass runs fp32 HIGHEST regardless of policy.trailing /
    q_store (round-3 ADVICE item 2, extended to the scan drivers —
    pre-fix this exact 512^2 case measured orth 9.2e-3 (bgs) / 5.2e-2
    (bgs2) and bf16-class backward 1.6e-3; post-fix 1.1e-6 / 6.2e-6 with
    fp32-class backward).  Round-5c: reorth tiers now RETURN Q fp32 too —
    MIXED_FAST's bf16 return residency used to quantize QtQ to ~7.8e-4
    (the bf16 STORAGE floor), wasting the scrub, so BOTH policies must
    land in the same fp32 class (measured here: 4.8e-7 bgs2 / 3.6e-7
    bgs, backward 3.1e-7 — the scan reorth tiers run the whole loop
    fp32)."""
    from mixedprecisionblockqr_tpu.ops.policy import POLICY_MIXED_FAST

    a = _rand(512, 512, seed=25) - 0.5
    for pol, lim, blim in ((POLICY_MIXED, 1e-5, 1e-5),
                           (POLICY_MIXED_FAST, 1e-5, 1e-5)):
        Q, R = block_qr(jnp.asarray(a), 64, pol, mode="complete",
                        panel_method=pm, loop_mode="scan", group_panels=4)
        orth = float(metrics.orthogonality_error(np.asarray(Q, np.float32)))
        bwd = float(metrics.backward_error(
            a, np.asarray(Q, np.float32), np.asarray(R, np.float32)))
        assert orth < lim and bwd < blim, (pm, pol.q_store, orth, bwd)


def test_block_qr_bgs_scan_matches_unrolled_quality():
    """Same matrix through scan-BGS and unrolled BGS: quality class equal
    (not bitwise — different projection order), both inside criteria."""
    from mixedprecisionblockqr_tpu.ops import metrics
    from mixedprecisionblockqr_tpu.ops.blockqr import block_qr

    a = _rand(384, 384, seed=23)
    reps = {}
    for lm in ("scan", "unroll"):
        # check='sync': positive-uniform input is the documented correlated
        # stressor — the canary may fire and take the robust retry.
        Q, R = block_qr(jnp.asarray(a), 128, POLICY_FP32, mode="complete",
                        panel_method="bgs", loop_mode=lm, check="sync")
        reps[lm] = metrics.evaluate(a, np.asarray(Q), np.asarray(R),
                                    precision_bits=23)
        assert reps[lm].all_ok, f"{lm}: {reps[lm]}"
    assert reps["scan"].backward < 10 * max(reps["unroll"].backward, 1e-7)


def test_block_qr_bgs_scan_qtb():
    """Scan-BGS B path: Q^T b accumulates per panel block without
    materializing Q in the caller."""
    from mixedprecisionblockqr_tpu.ops.blockqr import _block_qr_bgs_scan

    rng = np.random.default_rng(24)
    a = rng.standard_normal((384, 384)).astype(np.float32)
    b = rng.standard_normal((384, 3)).astype(np.float32)
    import jax

    R, Q, QtB = jax.jit(
        lambda x, y: _block_qr_bgs_scan(
            x, 128, POLICY_FP32, True, y, False, reorth=True)
    )(jnp.asarray(a), jnp.asarray(b))
    ref = np.asarray(Q).T @ b
    np.testing.assert_allclose(np.asarray(QtB), ref, atol=1e-4)


def test_bgs_positive_uniform_recovers():
    """The reference's positive-uniform generator (h_generate_random_matrix)
    produces CORRELATED columns — the documented stressor for fixed-budget
    NS chains.  The public API must return a criteria-passing factorization
    either way (in-kernel convergence or the NaN-canary retry path)."""
    a = np.random.default_rng(0).random((512, 512)).astype(np.float32)
    Q, R = block_qr(jnp.asarray(a), 128, POLICY_MIXED, mode="complete",
                    panel_method="bgs1", check="sync")
    rep = metrics.evaluate(a, np.asarray(Q), np.asarray(R), precision_bits=8)
    assert rep.all_ok and np.isfinite(np.asarray(R)).all(), str(rep)


def test_fp64_rejects_fp32_ns_tiers():
    """The NS throughput tiers run fp32 chains; the fp64 oracle policy
    must refuse them instead of silently demoting precision."""
    from mixedprecisionblockqr_tpu.ops.policy import POLICY_FP64

    A = _rand(64, 64, seed=30).astype(np.float64)
    for pm in ("bgs", "bgs1", "polar"):
        with pytest.raises(ValueError, match="fp32 NS"):
            block_qr(A, block_size=16, policy=POLICY_FP64, panel_method=pm)


def test_fp64_rejects_fp32_ns_tiers_qtb():
    """Same refusal through block_qr_qtb / lstsq (round-2 ADVICE item 1:
    the guard lived only in block_qr, so lstsq(policy=fp64,
    panel_method='bgs1') silently demoted the chain to fp32)."""
    from mixedprecisionblockqr_tpu.ops.blockqr import block_qr_qtb
    from mixedprecisionblockqr_tpu.ops.policy import POLICY_FP64

    A = _rand(64, 64, seed=31).astype(np.float64)
    b = np.ones(64, dtype=np.float64)
    for pm in ("bgs", "bgs1", "polar"):
        with pytest.raises(ValueError, match="fp32 NS"):
            block_qr_qtb(A, b, block_size=16, policy=POLICY_FP64,
                         panel_method=pm)


def test_resolve_auto_dispatch_table():
    """panel_method='auto' encodes the dispatch table.  Assert its choices
    on a (named) GPU platform and the robust fallbacks elsewhere."""
    from mixedprecisionblockqr_tpu.ops.blockqr import resolve_panel_config
    from mixedprecisionblockqr_tpu.ops.policy import (
        POLICY_FP64,
        POLICY_MIXED,
        POLICY_MIXED_FAST,
    )

    def auto(m, n, policy, platform="gpu", mode="complete"):
        return resolve_panel_config(
            m, n, 128, policy, "auto", "unroll", 4, mode=mode,
            platform=platform,
        )

    assert auto(2048, 2048, POLICY_MIXED) == ("bgs1", "unroll", 8)
    assert auto(4096, 4096, POLICY_MIXED) == ("bgs1", "unroll", 8)
    assert auto(8192, 8192, POLICY_MIXED_FAST) == ("bgs1", "unroll", 8)
    assert auto(16384, 16384, POLICY_MIXED_FAST) == ("bgs1", "scan", 4)
    # fp32 -> the reorthogonalized BGS tier (fp32-roundoff quality).
    assert auto(2048, 2048, POLICY_FP32)[0] == "bgs"
    # Other platforms, fp64, and hostile shapes -> the robust reference tier.
    assert auto(2048, 2048, POLICY_MIXED, platform="cpu")[0] == "householder"
    assert auto(2048, 2048, POLICY_FP64)[0] == "householder"
    assert auto(2048, 1000, POLICY_MIXED)[0] == "householder"  # r !| n
    # complete-mode tall matrices cannot take the concatenation-Q BGS
    # driver: the fallback chain lands on the reflector tier.
    pm, _, _ = auto(4096, 2048, POLICY_MIXED, mode="complete")
    assert pm in ("polar", "cholqr1")


def test_qr_auto_default_end_to_end():
    """qr()'s default now routes through auto dispatch; on CPU that is the
    householder tier — quality must be reference-class."""
    a = _rand(192, 160, seed=32)
    Q, R = qr(a, block_size=64, policy=POLICY_FP32)
    assert Q.shape == (192, 160) and R.shape == (160, 160)
    rep = metrics.evaluate(
        a, np.asarray(Q), np.asarray(R), precision_bits=23
    )
    assert rep.all_ok, str(rep)


def test_quality_ladder_mapping():
    """quality= maps to the documented BGS ladder rungs under auto dispatch
    — without knowing internal method strings."""
    from mixedprecisionblockqr_tpu.ops.blockqr import resolve_panel_config
    from mixedprecisionblockqr_tpu.ops.policy import POLICY_MIXED

    def auto(m, n, policy, quality, platform="gpu"):
        return resolve_panel_config(
            m, n, 128, policy, "auto", "unroll", 4, mode="complete",
            platform=platform, quality=quality,
        )

    assert auto(2048, 2048, POLICY_MIXED, "fast") == ("bgs1", "unroll", 8)
    assert auto(2048, 2048, POLICY_MIXED, "balanced") == ("bgs2", "unroll", 8)
    assert auto(2048, 2048, POLICY_MIXED, "high") == ("bgs", "unroll", 8)
    assert auto(2048, 2048, POLICY_MIXED, "robust")[0] == "householder"
    assert auto(8192, 8192, POLICY_MIXED, "balanced") == ("bgs2", "unroll", 8)
    assert auto(16384, 16384, POLICY_MIXED, "high") == ("bgs", "scan", 4)
    # fp32 default = the 'high' rung; quality trades down explicitly.
    assert auto(2048, 2048, POLICY_FP32, None)[0] == "bgs"
    assert auto(2048, 2048, POLICY_FP32, "fast")[0] == "bgs1"
    # On other platforms every rung stays on the robust oracle tier.
    assert auto(2048, 2048, POLICY_MIXED, "high", platform="cpu")[0] == (
        "householder"
    )
    # quality= is an auto-dispatch knob: explicit panel_method conflicts.
    import pytest

    with pytest.raises(ValueError, match="quality"):
        resolve_panel_config(
            2048, 2048, 128, POLICY_MIXED, "bgs1", "unroll", 4,
            platform="gpu", quality="fast",
        )
    with pytest.raises(ValueError, match="quality"):
        resolve_panel_config(
            2048, 2048, 128, POLICY_MIXED, "auto", "unroll", 4,
            platform="gpu", quality="ultra",
        )


def test_quality_ladder_end_to_end():
    """Each ladder rung produces a criteria-passing factorization through
    the public qr() (CPU resolves to householder; the mapping itself is
    asserted in test_quality_ladder_mapping, the on-card quality numbers
    by chip_smoke.py)."""
    a = _rand(256, 256, seed=7)
    for quality in ("fast", "balanced", "high", "robust"):
        Q, R = qr(a, block_size=64, policy=POLICY_FP32, quality=quality)
        rep = metrics.evaluate(
            a, np.asarray(Q), np.asarray(R), precision_bits=23
        )
        assert rep.all_ok, f"{quality}: {rep}"


def test_check_defer_propagates_nan_poison():
    """check='defer' (the default) must NOT host-sync or retry: a poisoned
    factorization surfaces as NaN in the outputs, and check='sync' on the
    same input transparently recovers through the robust tier."""
    # Rank-deficient correlated columns: hostile to fixed-budget NS chains.
    rng = np.random.default_rng(3)
    base = rng.random((512, 4)).astype(np.float32)
    a = np.repeat(base, 128, axis=1) + 1e-6 * rng.standard_normal(
        (512, 512)
    ).astype(np.float32)
    Qd, Rd = block_qr(jnp.asarray(a), 128, POLICY_MIXED, mode="complete",
                      panel_method="bgs1", check="defer")
    assert not np.isfinite(np.asarray(Rd)[0, 0]), (
        "expected the NaN canary to fire on rank-deficient input"
    )
    Qs, Rs = block_qr(jnp.asarray(a), 128, POLICY_MIXED, mode="complete",
                      panel_method="bgs1", check="sync")
    assert np.isfinite(np.asarray(Rs)).all()
    rep = metrics.evaluate(a, np.asarray(Qs), np.asarray(Rs),
                           precision_bits=8)
    assert rep.all_ok, str(rep)


@pytest.mark.parametrize("pm", ["bgs1", "bgs2", "bgs"])
@pytest.mark.parametrize("m,n", [(256, 256), (192, 128)])
def test_bgs_r_exactly_triangular(pm, m, n):
    """The BGS drivers assemble R from exact pieces (zeros init, masked
    r x r diagonal blocks, strictly-above projection blocks) so the
    driver skips the final full-matrix ``jnp.triu``.  This is the guard: every below-diagonal entry
    must be EXACTLY zero — any new diagonal-block producer that forgets
    its `where(cols >= rows, ..., 0)` mask fails here, not in prod."""
    from mixedprecisionblockqr_tpu.ops.policy import POLICY_MIXED_FAST

    for policy in (POLICY_MIXED_FAST, POLICY_FP32):
        A = _rand(m, n, seed=m + len(pm))
        Q, R = block_qr(A, block_size=32, policy=policy, mode="reduced",
                        panel_method=pm, group_panels=4)
        Rnp = np.asarray(R, dtype=np.float64)
        assert np.all(np.tril(Rnp, -1) == 0.0), (
            f"{pm} {policy}: max |tril| = {np.abs(np.tril(Rnp, -1)).max()}"
        )
