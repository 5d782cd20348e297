"""Round-5b omega-scheduled NS chains + estimated-true residual reporting.

The fast NS tiers false-poisoned EVERY Bierlaire-conditioned input (the
reference's own condition-number generator, ``python/utils.py:13``):
structured panels carry cond(G) ~ 40-700 where the aspect-calibrated
budgets assumed random-panel cond(G) ~ 3-9, and the free one-behind
residual over-reported converged chains by its square root.  Two fixes,
each regression-tested here:

  1. omega burst (``ops/polar.py::ns_omega_iters``): early iterations
     over-relax (x4/iter small-eigenvalue escape, same dot count);
  2. plain chains aggregate the SQUARED one-behind correction (the
     quadratic estimate of the true residual) into the poison canary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mixedprecisionblockqr_tpu.ops import metrics
from mixedprecisionblockqr_tpu.ops.blockqr import _block_qr_bgs, block_qr
from mixedprecisionblockqr_tpu.ops.policy import POLICY_MIXED_FAST
from mixedprecisionblockqr_tpu.ops.polar import (
    ns_omega_iters,
    tri_inv_chol,
)
from mixedprecisionblockqr_tpu.utils.datagen import conditioned_matrix


def _true_resid(X, G):
    Xn = np.asarray(X, np.float64)
    Gn = np.asarray(G, np.float64)
    return np.max(np.abs(np.eye(G.shape[0]) - Xn.T @ Gn @ Xn))


def test_omega_schedule_shape():
    assert ns_omega_iters(4) == 0
    assert ns_omega_iters(6) == 2
    assert ns_omega_iters(7) == 3
    assert ns_omega_iters(14) == 4  # capped: long bursts diverge


def test_omega_widens_basin_same_cost():
    """cond(G) ~ 40 (a cond-1e3 draw's panel): 7 omega iterations reach
    roundoff where 7 plain ones stall two orders higher."""
    P = conditioned_matrix(512, condition_number=1e3, seed=7)[:, :64].astype(
        np.float32
    )
    G = jnp.asarray((P.T @ P).astype(np.float32))
    X_om = tri_inv_chol(G, iters=7, omega=True)
    X_pl = tri_inv_chol(G, iters=7, omega=False)
    assert _true_resid(X_om, G) < 1e-5
    assert _true_resid(X_pl, G) > 10 * _true_resid(X_om, G)


def test_omega_no_floor_regression_on_random():
    rng = np.random.default_rng(3)
    P = rng.standard_normal((512, 64)).astype(np.float32)
    G = jnp.asarray((P.T @ P).astype(np.float32))
    X = tri_inv_chol(G, iters=7, omega=True)
    assert _true_resid(X, G) < 2e-6


def test_conditioned_draw_no_false_poison():
    """The round-5b regression: a cond-1e3 Bierlaire draw must complete on
    the fast tier (no canary) and pass the acceptance criteria."""
    a = conditioned_matrix(512, condition_number=1e3, seed=7).astype(
        np.float32
    )
    R, Q, _ = _block_qr_bgs(
        jnp.asarray(a), 64, POLICY_MIXED_FAST, True, None, group_panels=8,
        reorth=False,
    )
    Rn = np.asarray(R, np.float32)
    assert np.isfinite(Rn[0, 0]), "canary false-fired on a cond-1e3 draw"
    rep = metrics.evaluate(a, np.asarray(Q, np.float32), Rn,
                           precision_bits=8)
    assert rep.all_ok


def test_hostile_draw_still_poisons():
    """True-positive retention: cond 1e7 genuinely breaks the one-pass
    Gram tier (measured orth ~0.6 with the canary disabled) and must
    still trip it."""
    a = conditioned_matrix(512, condition_number=1e7, seed=7).astype(
        np.float32
    )
    R, Q, _ = _block_qr_bgs(
        jnp.asarray(a), 64, POLICY_MIXED_FAST, True, None, group_panels=8,
        reorth=False,
    )
    assert not np.isfinite(np.asarray(R[0, 0]))


def test_hostile_draw_sync_retry_recovers():
    """check='sync' turns the poison into a transparent robust-tier retry
    — the public contract for hostile spectra."""
    a = conditioned_matrix(256, condition_number=1e7, seed=7).astype(
        np.float32
    )
    Q, R = block_qr(jnp.asarray(a), 32, POLICY_MIXED_FAST, mode="reduced",
                    panel_method="bgs1", check="sync")
    rep = metrics.evaluate(a, np.asarray(Q, np.float32),
                           np.asarray(R, np.float32), precision_bits=8)
    assert rep.all_ok
