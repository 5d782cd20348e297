"""Distributed blocked QR on the virtual 8-device mesh — the multi-chip
tests the reference lacks entirely (SURVEY §4: "no distributed testing or
fake backend exists"), using the same oracle pattern on a host-simulated
mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mixedprecisionblockqr_tpu.models.lstsq import back_substitution
from mixedprecisionblockqr_tpu.ops import metrics
from mixedprecisionblockqr_tpu.ops.blockqr import block_qr
from mixedprecisionblockqr_tpu.ops.policy import POLICY_FP32, POLICY_MIXED
from mixedprecisionblockqr_tpu.parallel.dist_qr import dist_block_qr
from mixedprecisionblockqr_tpu.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


def test_dist_qr_matches_single_chip(mesh):
    A = np.random.default_rng(0).random((128, 64)).astype(np.float32)
    Qd, Rd = dist_block_qr(A, mesh, block_size=16, mode="complete")
    rep = metrics.evaluate(A, Qd, Rd, precision_bits=23)
    assert rep.all_ok, str(rep)
    # R agrees with the single-chip driver up to column signs.
    Rs = block_qr(A, block_size=16, mode="r")
    np.testing.assert_allclose(
        np.abs(np.diag(np.asarray(Rd)[:64])), np.abs(np.diag(np.asarray(Rs))),
        rtol=1e-3,
    )


def test_dist_qr_reduced(mesh):
    A = np.random.default_rng(1).random((256, 64)).astype(np.float32)
    Q, R = dist_block_qr(A, mesh, block_size=32, mode="reduced")
    assert Q.shape == (256, 64)
    assert float(metrics.backward_error(jnp.asarray(A), Q, R[:64])) < 1e-5


def test_dist_qr_mixed_policy(mesh):
    A = np.random.default_rng(2).random((256, 128)).astype(np.float32)
    Q, R = dist_block_qr(A, mesh, block_size=32, policy=POLICY_MIXED,
                         mode="complete")
    rep = metrics.evaluate(A, Q, R, precision_bits=8)
    assert rep.all_ok, str(rep)


def test_dist_lstsq(mesh):
    rng = np.random.default_rng(3)
    A = rng.random((256, 96)).astype(np.float32)
    xtrue = rng.random(96).astype(np.float32)
    b = A @ xtrue
    R, qtb = dist_block_qr(A, mesh, block_size=32, mode="r", b=b)
    x = np.asarray(back_substitution(R[:96, :], qtb[:96, 0]))
    np.testing.assert_allclose(x, xtrue, atol=5e-3)


def test_dist_qr_block_size_guard(mesh):
    A = np.random.default_rng(4).random((128, 64)).astype(np.float32)
    # per-device rows = 16; block 24 does not divide -> error
    with pytest.raises(ValueError):
        dist_block_qr(A, mesh, block_size=24, mode="r")


def test_graft_dryrun():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_dist_qr_cholqr2_panels(mesh):
    # block 16 on 32 rows/device: aspect-2 leaves (the square-leaf guard
    # rejects block 32 here — see test_dist_qr_square_leaf_guard).
    A = np.random.default_rng(5).random((256, 128)).astype(np.float32)
    Q, R = dist_block_qr(A, mesh, block_size=16, mode="complete",
                         panel_method="cholqr2")
    rep = metrics.evaluate(A, Q, R, precision_bits=23)
    assert rep.all_ok, str(rep)


def test_dist_qr_cholqr2_mixed(mesh):
    A = np.random.default_rng(6).random((256, 128)).astype(np.float32)
    Q, R = dist_block_qr(A, mesh, block_size=16, policy=POLICY_MIXED,
                         mode="complete", panel_method="cholqr2")
    rep = metrics.evaluate(A, Q, R, precision_bits=8)
    assert rep.all_ok, str(rep)


def test_batched_sharded_dp():
    from mixedprecisionblockqr_tpu.parallel.batched import (
        block_qr_batched_sharded,
    )
    from mixedprecisionblockqr_tpu.parallel.mesh import BATCH_AXIS, make_mesh

    mesh = make_mesh((8,), (BATCH_AXIS,))
    A = np.random.default_rng(7).random((8, 96, 48)).astype(np.float32)
    Q, R = block_qr_batched_sharded(A, mesh, block_size=16)
    Qn, Rn = np.asarray(Q), np.asarray(R)
    for i in range(8):
        err = float(
            metrics.backward_error(
                jnp.asarray(A[i]), jnp.asarray(Qn[i]), jnp.asarray(Rn[i])
            )
        )
        assert err < 1e-5, (i, err)


def test_tsqr_batched_sharded_2d_mesh():
    from mixedprecisionblockqr_tpu.parallel.batched import (
        tsqr_batched_sharded_2d,
    )
    from mixedprecisionblockqr_tpu.parallel.mesh import (
        BATCH_AXIS,
        ROWS_AXIS,
        make_mesh,
    )

    mesh = make_mesh((2, 4), (BATCH_AXIS, ROWS_AXIS))
    A = np.random.default_rng(8).random((4, 256, 16)).astype(np.float32)
    Q, R = tsqr_batched_sharded_2d(A, mesh)
    assert "batch" in str(Q.sharding.spec) and "rows" in str(Q.sharding.spec)
    Qn, Rn = np.asarray(Q), np.asarray(R)
    for i in range(4):
        err = float(
            metrics.backward_error(
                jnp.asarray(A[i]), jnp.asarray(Qn[i]), jnp.asarray(Rn[i])
            )
        )
        assert err < 1e-5, (i, err)


def test_dist_qr_scan_mode(mesh):
    """scan loop_mode: one compiled panel step via fori_loop (the
    compile-scalable path for 16384^2-class problems)."""
    A = np.random.default_rng(9).random((256, 128)).astype(np.float32)
    Q, R = dist_block_qr(A, mesh, block_size=16, mode="complete",
                         loop_mode="scan", panel_method="cholqr2")
    rep = metrics.evaluate(A, Q, R, precision_bits=23)
    assert rep.all_ok, str(rep)
    # Matches the unrolled path bit-for-bit in structure (same math):
    Qu, Ru = dist_block_qr(A, mesh, block_size=16, mode="complete",
                           panel_method="cholqr2")
    np.testing.assert_allclose(
        np.abs(np.diag(np.asarray(R)[:128])),
        np.abs(np.diag(np.asarray(Ru)[:128])), rtol=1e-4,
    )


def test_dist_qr_scan_lstsq(mesh):
    rng = np.random.default_rng(10)
    A = rng.random((256, 64)).astype(np.float32)
    xt = rng.random(64).astype(np.float32)
    b = A @ xt
    R, qtb = dist_block_qr(A, mesh, block_size=32, mode="r", b=b,
                           loop_mode="scan")
    x = np.asarray(back_substitution(R[:64, :], qtb[:64, 0]))
    np.testing.assert_allclose(x, xt, atol=5e-3)


def test_dist_qr_2d_mesh():
    """2-D (rows x cols) sharded QR — SURVEY §7.7's plan: TSQR panel over
    rows, column-broadcast of the reflector, trailing updates local+psum."""
    from mixedprecisionblockqr_tpu.parallel.dist_qr2d import (
        COLS_AXIS,
        dist_block_qr_2d,
    )
    from mixedprecisionblockqr_tpu.parallel.mesh import ROWS_AXIS, make_mesh

    mesh2d = make_mesh((4, 2), (ROWS_AXIS, COLS_AXIS))
    rng = np.random.default_rng(11)
    A = rng.random((256, 128)).astype(np.float32)
    xt = rng.random(128).astype(np.float32)
    b = A @ xt
    R, qtb = dist_block_qr_2d(A, mesh2d, block_size=32, b=b)
    Rn = np.asarray(R)
    assert np.allclose(np.tril(Rn, -1), 0)
    Rref = np.linalg.qr(A)[1]
    np.testing.assert_allclose(
        np.abs(np.diag(Rn[:128])), np.abs(np.diag(Rref)), rtol=1e-3
    )
    x = np.asarray(back_substitution(Rn[:128, :], np.asarray(qtb)[:128, 0]))
    np.testing.assert_allclose(x, xt, atol=1e-3)


def test_dist_qr_2d_cholqr_panels():
    from mixedprecisionblockqr_tpu.parallel.dist_qr2d import (
        COLS_AXIS,
        dist_block_qr_2d,
    )
    from mixedprecisionblockqr_tpu.parallel.mesh import ROWS_AXIS, make_mesh

    mesh2d = make_mesh((2, 4), (ROWS_AXIS, COLS_AXIS))
    A = np.random.default_rng(12).random((128, 64)).astype(np.float32)
    R = dist_block_qr_2d(A, mesh2d, block_size=16, panel_method="cholqr2")
    Rref = np.linalg.qr(A)[1]
    np.testing.assert_allclose(
        np.abs(np.diag(np.asarray(R)[:64])), np.abs(np.diag(Rref)), rtol=1e-2
    )


def test_dist_qr_2d_complete_q():
    from mixedprecisionblockqr_tpu.parallel.dist_qr2d import (
        COLS_AXIS,
        dist_block_qr_2d,
    )
    from mixedprecisionblockqr_tpu.parallel.mesh import ROWS_AXIS, make_mesh

    mesh2d = make_mesh((4, 2), (ROWS_AXIS, COLS_AXIS))
    A = np.random.default_rng(13).random((256, 128)).astype(np.float32)
    Qt, R = dist_block_qr_2d(A, mesh2d, block_size=32, mode="complete")
    Qn = np.asarray(Qt).T
    Rfull = np.vstack([np.asarray(R), np.zeros((128, 128), np.float32)])
    assert (
        np.linalg.norm(A - Qn @ Rfull) / np.linalg.norm(A) < 1e-5
    )
    assert np.abs(Qn.T @ Qn - np.eye(256)).max() < 1e-5


def test_dist_qr_2d_scan_mode():
    """2-D scan mode (round-2 VERDICT item 2): one compiled panel step,
    full-width updates — must match the unrolled path and numpy."""
    from mixedprecisionblockqr_tpu.parallel.dist_qr2d import (
        COLS_AXIS,
        dist_block_qr_2d,
    )
    from mixedprecisionblockqr_tpu.parallel.mesh import ROWS_AXIS, make_mesh

    mesh2d = make_mesh((4, 2), (ROWS_AXIS, COLS_AXIS))
    rng = np.random.default_rng(14)
    A = rng.random((256, 128)).astype(np.float32)
    xt = rng.random(128).astype(np.float32)
    b = A @ xt
    R, qtb = dist_block_qr_2d(
        A, mesh2d, block_size=32, b=b, panel_method="cholqr2",
        loop_mode="scan",
    )
    Rn = np.asarray(R)
    assert np.allclose(np.tril(Rn[:128], -1), 0)
    Rref = np.linalg.qr(A)[1]
    np.testing.assert_allclose(
        np.abs(np.diag(Rn[:128])), np.abs(np.diag(Rref)), rtol=1e-3
    )
    x = np.asarray(back_substitution(Rn[:128, :], np.asarray(qtb)[:128, 0]))
    np.testing.assert_allclose(x, xt, atol=1e-3)


def test_dist_qr_2d_scan_complete_q():
    from mixedprecisionblockqr_tpu.parallel.dist_qr2d import (
        COLS_AXIS,
        dist_block_qr_2d,
    )
    from mixedprecisionblockqr_tpu.parallel.mesh import ROWS_AXIS, make_mesh

    mesh2d = make_mesh((4, 2), (ROWS_AXIS, COLS_AXIS))
    A = np.random.default_rng(15).random((128, 64)).astype(np.float32)
    Qt, R = dist_block_qr_2d(
        A, mesh2d, block_size=16, mode="complete", loop_mode="scan"
    )
    Qn = np.asarray(Qt).T
    Rfull = np.vstack([np.asarray(R), np.zeros((64, 64), np.float32)])
    assert np.linalg.norm(A - Qn @ Rfull) / np.linalg.norm(A) < 1e-5
    assert np.abs(Qn.T @ Qn - np.eye(128)).max() < 1e-5


@pytest.mark.parametrize("lam", [0, 16, 48, 96, 112])
def test_dist_reflector_offset_sweep(mesh, lam):
    """Offset-axis sweep of the lam-anchored distributed reflector
    (dist_qr.py::_panel_reflector) — the reference sweeps a global_offset
    axis in test_iterator_dev_wy_funcs (Cuda/qr.cu:1910-1942); round-1
    VERDICT missing item 4.  For each anchor: the reconstructed
    H = I - Y Sinv Y^T must be orthogonal, act as identity on rows < lam,
    and map the panel to [R; 0]."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mixedprecisionblockqr_tpu.parallel.dist_qr import _panel_reflector
    from mixedprecisionblockqr_tpu.parallel.mesh import ROWS_AXIS

    m, n, w = 128, 128, 16
    h = m // mesh.shape[ROWS_AXIS]
    A = np.random.default_rng(20 + lam).random((m, n)).astype(np.float32)

    def local(A_loc):
        # square_final as the drivers pass it: the lam + w == m anchor is
        # the Yamamoto breakdown domain (S = I - Q1^T with orthogonal Q1)
        # and routes through the exact compact-WY band factorization.
        return _panel_reflector(
            A_loc, lam, w, h, ROWS_AXIS, "householder",
            square_final=(m - lam == w),
        )

    fn = jax.jit(
        jax.shard_map(
            local, mesh=mesh, in_specs=P(ROWS_AXIS, None),
            out_specs=(P(ROWS_AXIS, None), P(), P()),
            check_vma=False,
        )
    )
    Y, Sinv, R_pan = fn(jnp.asarray(A))
    Yn = np.asarray(Y, np.float64)
    Sn = np.asarray(Sinv, np.float64)
    H = np.eye(m) - Yn @ Sn @ Yn.T
    # orthogonal, identity above the anchor
    assert np.abs(H.T @ H - np.eye(m)).max() < 1e-5, lam
    if lam:
        np.testing.assert_allclose(H[:lam, :lam], np.eye(lam), atol=1e-6)
        assert np.abs(H[:lam, lam:]).max() < 1e-6
    # zeroes the panel below the anchor band: H^T P = [*; R; 0]
    P_cols = A[:, lam : lam + w].copy()
    P_cols[:lam, :] = 0.0  # the driver masks rows above the panel
    HtP = H.T @ P_cols
    np.testing.assert_allclose(
        np.abs(HtP[lam : lam + w]), np.abs(np.asarray(R_pan, np.float64)),
        atol=1e-4,
    )
    if lam + w < m:
        assert np.abs(HtP[lam + w :]).max() < 1e-4, lam


def test_dist_qr_square_matrix(mesh):
    """SQUARE matrices end with a square final panel — the Yamamoto
    near-singular-S domain the offset sweep exposed; must be exact via the
    compact-WY band path in both loop modes."""
    A = np.random.default_rng(21).random((128, 128)).astype(np.float32)
    for lm in ("unroll", "scan"):
        Qd, Rd = dist_block_qr(A, mesh, block_size=16, mode="complete",
                               loop_mode=lm)
        rep = metrics.evaluate(A, Qd, Rd, precision_bits=23)
        assert rep.all_ok and rep.tight_ok, (lm, str(rep))


def test_dist_qr_cholqr2s_panels(mesh):
    """Shifted CholeskyQR leaves (round-3: the trailing-corner fix for
    large square factorizations — plain cholqr2 collapsed at 8192^2)."""
    A = np.random.default_rng(7).random((512, 256)).astype(np.float32)
    Q, R = dist_block_qr(A, mesh, block_size=32, mode="complete",
                         panel_method="cholqr2s", loop_mode="scan")
    rep = metrics.evaluate(A, Q, R, precision_bits=23)
    assert rep.all_ok, str(rep)


def test_dist_qr_square_leaf_guard(mesh):
    """cholqr leaves with per-device aspect < 2 are numerically unsafe
    (square trailing-corner leaf -> rank-deficient fp32 Gram): the driver
    must REFUSE, not silently degrade (8192^2/block-256 collapse)."""
    A = np.random.default_rng(8).random((256, 256)).astype(np.float32)
    with pytest.raises(ValueError, match="aspect"):
        dist_block_qr(A, mesh, block_size=32, mode="r",
                      panel_method="cholqr2")


def test_dist_bgs_matches_numpy(mesh):
    """Distributed Block Gram-Schmidt tier (round-2 VERDICT item 5a): the
    single-chip throughput structure inside shard_map — one psum per Gram /
    projection, Q by concatenation into the row-sharded buffer."""
    A = np.random.default_rng(10).random((256, 128)).astype(np.float32) - 0.5
    for pm in ("bgs", "bgs1"):
        Q, R = dist_block_qr(A, mesh, block_size=32, mode="reduced",
                             panel_method=pm)
        assert Q.shape == (256, 128) and R.shape == (128, 128)
        rep = metrics.evaluate(A, Q, np.asarray(R), precision_bits=23)
        assert rep.backward < 1e-5, (pm, str(rep))
        orth = float(metrics.orthogonality_error(Q))
        # 'bgs' (BCGS2) reaches fp32 roundoff; one-pass 'bgs1' is looser.
        assert orth < (1e-5 if pm == "bgs" else 1e-3), (pm, orth)
        d_ref = np.abs(np.diag(np.linalg.qr(A.astype(np.float64), mode="r")))
        np.testing.assert_allclose(
            np.abs(np.diag(np.asarray(R))), d_ref, rtol=1e-3
        )


def test_dist_bgs_complete_square(mesh):
    A = np.random.default_rng(11).random((128, 128)).astype(np.float32) - 0.5
    Q, R = dist_block_qr(A, mesh, block_size=16, mode="complete",
                         panel_method="bgs")
    rep = metrics.evaluate(A, Q, np.asarray(R), precision_bits=23)
    assert rep.all_ok, str(rep)


def test_dist_bgs_qtb_lstsq(mesh):
    rng = np.random.default_rng(12)
    A = rng.random((256, 64)).astype(np.float32) - 0.5
    xtrue = rng.random(64).astype(np.float32)
    b = A @ xtrue
    R, qtb = dist_block_qr(A, mesh, block_size=32, mode="r", b=b,
                           panel_method="bgs")
    x = np.asarray(back_substitution(np.asarray(R)[:64, :],
                                     np.asarray(qtb)[:64, 0]))
    np.testing.assert_allclose(x, xtrue, atol=5e-3)


def test_dist_bgs_mixed_policy(mesh):
    A = np.random.default_rng(13).random((256, 128)).astype(np.float32) - 0.5
    Q, R = dist_block_qr(A, mesh, block_size=32, policy=POLICY_MIXED,
                         mode="reduced", panel_method="bgs1")
    rep = metrics.evaluate(A, Q, np.asarray(R), precision_bits=8)
    assert rep.all_ok, str(rep)


def test_dist_bgs_posuni_head_panel(mesh):
    """Round-7 regression, distributed mirror: POSITIVE-uniform input (the
    reference's default generator — no centering) whose unprojected head
    panel's outlier-spectrum Gram (cond(M0) ~ 4e2 at 512x64) out-conds the
    aspect budget; pre-fix the dist bgs1 tier NaN-poisoned on it."""
    A = np.random.default_rng(14).random((512, 256)).astype(np.float32)
    Q, R = dist_block_qr(A, mesh, block_size=64, policy=POLICY_MIXED,
                         mode="reduced", panel_method="bgs1")
    assert np.isfinite(np.asarray(R)[0, 0]), "dist head panel poisoned"
    rep = metrics.evaluate(A, Q, np.asarray(R), precision_bits=8)
    assert rep.all_ok, str(rep)


def test_dist_bgs_shape_guards(mesh):
    A = np.random.default_rng(14).random((128, 100)).astype(np.float32)
    with pytest.raises(ValueError, match="block_size"):
        dist_block_qr(A, mesh, block_size=32, panel_method="bgs")  # 32 !| 100
    A2 = np.random.default_rng(15).random((256, 128)).astype(np.float32)
    with pytest.raises(ValueError, match="complete"):
        dist_block_qr(A2, mesh, block_size=32, mode="complete",
                      panel_method="bgs")


def test_dist_bgs_scan_matches_unrolled(mesh):
    """Scan-mode distributed BGS (one compiled panel step; BCGS2 + robust
    panels) — quality parity with the unrolled tier and the numpy oracle."""
    A = np.random.default_rng(16).random((256, 128)).astype(np.float32) - 0.5
    Qs, Rs = dist_block_qr(A, mesh, block_size=32, mode="reduced",
                           panel_method="bgs", loop_mode="scan")
    rep = metrics.evaluate(A, Qs, np.asarray(Rs), precision_bits=23)
    assert rep.backward < 1e-5, str(rep)
    assert float(metrics.orthogonality_error(Qs)) < 1e-5
    d_ref = np.abs(np.diag(np.linalg.qr(A.astype(np.float64), mode="r")))
    np.testing.assert_allclose(np.abs(np.diag(np.asarray(Rs))), d_ref,
                               rtol=1e-3)


def test_dist_bgs_scan_qtb(mesh):
    rng = np.random.default_rng(17)
    A = rng.random((256, 64)).astype(np.float32) - 0.5
    xtrue = rng.random(64).astype(np.float32)
    b = A @ xtrue
    R, qtb = dist_block_qr(A, mesh, block_size=32, mode="r", b=b,
                           panel_method="bgs", loop_mode="scan")
    x = np.asarray(back_substitution(np.asarray(R)[:64, :],
                                     np.asarray(qtb)[:64, 0]))
    np.testing.assert_allclose(x, xtrue, atol=5e-3)


def test_dist_bgs_scan_grouped(mesh):
    """Grouped scan-mode dist BGS (round-3 VERDICT item 2): each fori step
    factors group_panels panels with ONE full-width Qbuf collective pass +
    eager in-group projections, and pre-tail panels take the plain-chain
    lax.cond branch (1 Gram collective) instead of the robust 3."""
    A = np.random.default_rng(14).random((256, 128)).astype(np.float32) - 0.5
    d_ref = np.abs(np.diag(np.linalg.qr(A.astype(np.float64), mode="r")))
    for g in (2, 4):
        Q, R = dist_block_qr(A, mesh, block_size=16, mode="reduced",
                             panel_method="bgs1", loop_mode="scan",
                             group_panels=g)
        assert Q.shape == (256, 128) and R.shape == (128, 128)
        rep = metrics.evaluate(A, Q, np.asarray(R), precision_bits=23)
        assert rep.backward < 1e-5, (g, str(rep))
        orth = float(metrics.orthogonality_error(Q))
        assert orth < 1e-3, (g, orth)  # single-pass tier bound
        np.testing.assert_allclose(
            np.abs(np.diag(np.asarray(R))), d_ref, rtol=1e-3
        )
    # g that does not divide nb falls back to per-panel (still correct).
    Q3, R3 = dist_block_qr(A, mesh, block_size=16, mode="reduced",
                           panel_method="bgs1", loop_mode="scan",
                           group_panels=3)
    rep3 = metrics.evaluate(A, Q3, np.asarray(R3), precision_bits=23)
    assert rep3.backward < 1e-5, str(rep3)


def test_dist_bgs2_scan_grouped(mesh):
    """Distributed 'bgs2' scan tier (grouped inter-group BCGS2): keeps the
    grouped collective structure (one DOUBLE Qbuf pass per group) while
    scrubbing the inter-group drift that broke the 16384^2 fp32 criterion
    for bgs1 (orth 4.0e-3 vs limit 1.95e-3 on an 8-device CPU mesh; bgs2
    at 4096^2: 3.9e-5 vs bgs1's 1.6e-4).  The drift only separates the tiers at cert scale — suite
    shapes sit on the fp32 roundoff floor — so this is a PATH-correctness
    test: the scrubbed driver must deliver floor-class quality and the
    true factorization (R-diag parity with np.linalg.qr), and never be
    worse than bgs1."""
    A = np.random.default_rng(18).random((256, 128)).astype(np.float32) - 0.5
    orth = {}
    for pm in ("bgs1", "bgs2"):
        Q, R = dist_block_qr(A, mesh, block_size=16, mode="reduced",
                             panel_method=pm, loop_mode="scan",
                             group_panels=4)
        rep = metrics.evaluate(A, Q, np.asarray(R), precision_bits=23)
        assert rep.backward < 1e-5, (pm, str(rep))
        orth[pm] = float(metrics.orthogonality_error(Q))
        if pm == "bgs2":
            assert rep.all_ok, str(rep)
            d_ref = np.abs(
                np.diag(np.linalg.qr(A.astype(np.float64), mode="r"))
            )
            np.testing.assert_allclose(np.abs(np.diag(np.asarray(R))),
                                       d_ref, rtol=1e-3)
    assert orth["bgs2"] <= 1.5 * orth["bgs1"], orth


def test_dist_bgs_reorth_mixed_policy_orth(mesh):
    """The dist 'bgs' reorth tier under a MIXED policy must deliver the
    ladder's orthogonality class — the scrub and all projections run fp32
    HIGHEST regardless of policy.trailing (round-3 ADVICE item 2; before
    the fix the bf16 single-pass scrub pinned orth at ~0.1)."""
    from mixedprecisionblockqr_tpu.ops.policy import POLICY_MIXED

    A = np.random.default_rng(15).random((256, 128)).astype(np.float32) - 0.5
    Q, R = dist_block_qr(A, mesh, block_size=32, mode="reduced",
                         panel_method="bgs", policy=POLICY_MIXED)
    orth = float(metrics.orthogonality_error(np.asarray(Q, np.float32)))
    assert orth < 1e-4, orth


@pytest.mark.parametrize("pm", ["bgs", "bgs2"])
def test_dist_scan_reorth_mixed_policy_orth(mesh, pm):
    """The SCAN-mode dist reorth tiers under MIXED policies must deliver
    the same fp32-class orthogonality as the unrolled driver: Qbuf carries
    fp32 through the loop and every projection pass runs fp32 HIGHEST
    regardless of policy.trailing/q_store (the same ADVICE-item-2 class
    the unrolled driver was fixed for — before the fix the scan scrub ran
    at policy.trailing against a q_store-resident Qbuf and measured orth
    1.5e-2 (bgs) / 8.3e-2 (bgs2) at this exact 512^2 case; the fix gives
    1.2e-6 / 1.1e-5).  Round-5c: reorth tiers now RETURN Q fp32 too —
    MIXED_FAST's bf16 return residency used to quantize QtQ to ~6.7e-4
    (the bf16 STORAGE floor), wasting the fp32 scrub, so both policies
    must now land in the same fp32 class."""
    from mixedprecisionblockqr_tpu.ops.policy import (
        POLICY_MIXED,
        POLICY_MIXED_FAST,
    )

    A = np.random.default_rng(16).random((512, 512)).astype(np.float32) - 0.5
    for pol, lim in ((POLICY_MIXED, 1e-4), (POLICY_MIXED_FAST, 1e-4)):
        Q, R = dist_block_qr(A, mesh, block_size=32, mode="reduced",
                             panel_method=pm, loop_mode="scan",
                             group_panels=4, policy=pol)
        orth = float(metrics.orthogonality_error(np.asarray(Q, np.float32)))
        assert orth < lim, (pm, pol.q_store, orth)
        rep = metrics.evaluate(A, np.asarray(Q, np.float32), np.asarray(R),
                               precision_bits=8)
        assert rep.backward_ok, (pm, str(rep))


def test_dist_tail_rescrub_tight_gate(mesh):
    """The dist reorth tiers' post-factorization rescrub (the distributed
    mirror of the single-chip corner-leak fix — see ops/blockqr.py::
    _block_qr_bgs._tail_rescrub): the pre-factorization BCGS2 scrub's
    leftovers are amplified by the trailing corner's conditioning, leaving
    the final panels' cross terms ~kappa*eps above roundoff (the 16384^2
    CPU-mesh cert's 8.0e-5 orth floor was exactly this).  Post-fix all
    three dist reorth tiers reach the fp32 TIGHT gate 2^-23*sqrt(m)."""
    a = np.random.default_rng(0).random((512, 512)).astype(np.float32) - 0.5
    for pm, lm in (("bgs", "unroll"), ("bgs", "scan"), ("bgs2", "scan")):
        Q, R = dist_block_qr(a, mesh, block_size=64, mode="reduced",
                             panel_method=pm, loop_mode=lm, group_panels=4,
                             policy=POLICY_FP32)
        rep = metrics.evaluate(a, np.asarray(Q), np.asarray(R),
                               precision_bits=23)
        assert rep.all_ok, f"{pm}/{lm}: {rep}"
        assert rep.tight_ok, (
            f"{pm}/{lm}: orth {rep.orthogonality:.2e} must meet the fp32 "
            f"tight gate (corner-leak rescrub regression)")


def test_dist_tail_rescrub_covers_whole_robust_corner(mesh):
    """Dist mirror of the scan-rescrub coverage fix: nb=16 at g=2 puts the
    2-panel robust tail in the final step AND n_robust=2 == g, but nb=32
    at g=2 (this config) spreads max(2, nb//8)=4 robust panels across two
    steps — the second-to-last was previously never rescrubbed.  The
    shared D9 helper's psum path must reach the tight gate on a
    conditioned matrix."""
    from mixedprecisionblockqr_tpu.utils.datagen import conditioned_matrix

    a = conditioned_matrix(512, condition_number=1e5, seed=5).astype(
        np.float32
    )
    Q, R = dist_block_qr(a, mesh, block_size=16, mode="reduced",
                         panel_method="bgs2", loop_mode="scan",
                         group_panels=2, policy=POLICY_FP32)
    rep = metrics.evaluate(a, np.asarray(Q), np.asarray(R),
                           precision_bits=23)
    assert rep.all_ok and rep.tight_ok, str(rep)


def test_dist_quality_ladder(mesh):
    """dist_block_qr(quality=...) maps the same ladder as single-chip
    qr(quality=...): 'fast' -> bgs1 single-pass CGS, 'balanced' -> bgs2
    grouped BCGS2 (the certified 16384^2 config), 'robust' -> householder
    leaves — and the scrub tiers must measurably beat 'fast' on the same
    matrix (fp32, where the inter-group drift is the binding term)."""
    A = np.random.default_rng(33).random((512, 512)).astype(np.float32)
    orth = {}
    for q in ("fast", "balanced"):
        # block 16 -> 8 groups of 4: enough inter-group accumulation for
        # the single-pass drift to clear the fp32 floor (measured here:
        # fast ~1.5e-3, balanced ~3e-6; at block 32 both floor at 2e-6).
        Q, R = dist_block_qr(A, mesh, block_size=16, mode="reduced",
                             quality=q, loop_mode="scan", group_panels=4)
        rep = metrics.evaluate(A, np.asarray(Q), np.asarray(R),
                               precision_bits=23)
        assert rep.backward_ok, (q, str(rep))
        orth[q] = rep.orthogonality
    assert orth["balanced"] < 0.1 * orth["fast"], orth
    # robust -> reflector tier (works for m > n complete too)
    B = np.random.default_rng(34).random((256, 64)).astype(np.float32)
    Q, R = dist_block_qr(B, mesh, block_size=16, mode="complete",
                         quality="robust")
    rep = metrics.evaluate(B, np.asarray(Q), np.asarray(R),
                           precision_bits=23)
    assert rep.all_ok, str(rep)
    with pytest.raises(ValueError):
        dist_block_qr(A, mesh, block_size=32, quality="ultimate")


def test_dist_qr_2d_bgs_ladder():
    """2-D mesh BGS tier (round-4 VERDICT item 6): the throughput-flagship
    panel structure on rows x cols — Q by concatenation sharded like A,
    full-height Grams psum'd over rows, coefficient blocks folded over
    cols.  The reorth rung must reach fp32 roundoff; bgs1 is the
    single-pass rung."""
    from mixedprecisionblockqr_tpu.parallel.dist_qr2d import (
        COLS_AXIS,
        dist_block_qr_2d,
    )
    from mixedprecisionblockqr_tpu.parallel.mesh import ROWS_AXIS, make_mesh

    mesh2d = make_mesh((4, 2), (ROWS_AXIS, COLS_AXIS))
    A = np.random.default_rng(40).standard_normal((256, 128)).astype(
        np.float32
    )
    for pm, orth_tol in (("bgs", 1e-5), ("bgs2", 1e-5), ("bgs1", 1e-3)):
        Q, R = dist_block_qr_2d(A, mesh2d, block_size=32, panel_method=pm,
                                mode="reduced")
        Qn = np.asarray(Q)
        assert Qn.shape == (256, 128) and R.shape == (128, 128)
        rep = metrics.evaluate(A, Qn, np.asarray(R), precision_bits=23)
        assert rep.backward < 1e-5, (pm, str(rep))
        assert float(metrics.orthogonality_error(Qn)) < orth_tol, pm
        d_ref = np.abs(np.diag(np.linalg.qr(A.astype(np.float64),
                                            mode="r")))
        np.testing.assert_allclose(
            np.abs(np.diag(np.asarray(R))), d_ref, rtol=1e-3
        )


def test_dist_qr_2d_bgs_mixed_qtb():
    """Mixed policy on the 2-D BGS tier + Q^T b solve path: the reorth
    scrub runs fp32 HIGHEST regardless of policy (round-3 ADVICE item 2
    contract), so 'bgs' under POLICY_MIXED keeps fp32-class quality."""
    from mixedprecisionblockqr_tpu.parallel.dist_qr2d import (
        COLS_AXIS,
        dist_block_qr_2d,
    )
    from mixedprecisionblockqr_tpu.parallel.mesh import ROWS_AXIS, make_mesh

    mesh2d = make_mesh((4, 2), (ROWS_AXIS, COLS_AXIS))
    rng = np.random.default_rng(41)
    A = rng.standard_normal((256, 128)).astype(np.float32)
    xtrue = rng.random(128).astype(np.float32)
    b = A @ xtrue
    Q, R = dist_block_qr_2d(A, mesh2d, block_size=32, policy=POLICY_MIXED,
                            panel_method="bgs", mode="reduced")
    rep = metrics.evaluate(A, np.asarray(Q), np.asarray(R),
                           precision_bits=23)  # fp32-grade despite mixed
    assert rep.backward < 1e-5 and rep.orthogonality < 1e-5, str(rep)
    R2, qtb = dist_block_qr_2d(A, mesh2d, block_size=32, panel_method="bgs",
                               mode="r", b=b)
    x = np.asarray(back_substitution(np.asarray(R2)[:128, :],
                                     np.asarray(qtb)[:128, 0]))
    np.testing.assert_allclose(x, xtrue, atol=5e-3)


def test_dist_qr_2d_bgs_shape_guards():
    from mixedprecisionblockqr_tpu.parallel.dist_qr2d import (
        COLS_AXIS,
        dist_block_qr_2d,
    )
    from mixedprecisionblockqr_tpu.parallel.mesh import ROWS_AXIS, make_mesh

    mesh2d = make_mesh((4, 2), (ROWS_AXIS, COLS_AXIS))
    A = np.random.default_rng(42).random((256, 128)).astype(np.float32)
    with pytest.raises(ValueError, match="complete"):
        dist_block_qr_2d(A, mesh2d, block_size=32, panel_method="bgs",
                         mode="complete")
    with pytest.raises(ValueError, match="straddle column shards"):
        # n=128 over 2 col shards -> 64 per device; a 128-wide panel
        # would straddle both.
        dist_block_qr_2d(A, mesh2d, block_size=128, panel_method="bgs",
                         mode="r")
