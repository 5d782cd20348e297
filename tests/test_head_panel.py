"""Round-7 head-panel basin: positively-correlated inputs on the NS tiers.

The reference's DEFAULT test input is uniform [0,1)
(``h_generate_random_matrix``, ``Cuda/mmult.cuh:38-68``) — positively
correlated columns.  A driver's FIRST panel factors that data raw (every
later panel is projected/trailing-updated first and decorrelates), and its
Jacobi-scaled Gram carries an OUTLIER spectrum with cond(M0) ~ 1e3 that
the aspect-calibrated chain budgets cannot converge: before round 7 every
unrolled NS fast tier (bgs1/bgs2/bgs/polar) NaN-poisoned on the
reference's own input class at every size (measured stall: one-behind
0.5 at 1024^2 r=128).  Fix: ``ops/polar.py::tri_head_iters`` — the first
panel's chain runs base + 6 iterations.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mixedprecisionblockqr_tpu.ops import metrics
from mixedprecisionblockqr_tpu.ops.blockqr import block_qr
from mixedprecisionblockqr_tpu.ops.policy import POLICY_MIXED
from mixedprecisionblockqr_tpu.ops.polar import (
    tri_head_iters,
    tri_inv_chol,
    tri_iters_for_aspect,
)


def _posuni(m, n, seed):
    return np.random.default_rng(seed).random((m, n)).astype(np.float32)


def _true_resid(X, G):
    Xn = np.asarray(X, np.float64)
    Gn = np.asarray(G, np.float64)
    return np.max(np.abs(np.eye(G.shape[0]) - Xn.T @ Gn @ Xn))


def test_head_gram_needs_the_boost():
    """The exact stall: a positive-uniform 1024x128 head panel's Gram
    converges at the boosted budget and NOT at the raw aspect budget —
    documents why tri_head_iters exists."""
    P = _posuni(1024, 128, 2)
    G = jnp.asarray((P.astype(np.float64).T @ P.astype(np.float64)
                     ).astype(np.float32))
    base = tri_iters_for_aspect(1024 / 128)
    X_base = tri_inv_chol(G, iters=base)
    X_head = tri_inv_chol(G, iters=tri_head_iters(base))
    assert _true_resid(X_head, G) < 1e-4
    assert _true_resid(X_base, G) > 1e-2, (
        "raw aspect budget now converges the outlier class — recalibrate "
        "tri_head_iters downward?"
    )


@pytest.mark.parametrize("pm", ["bgs1", "bgs2", "bgs", "polar"])
def test_posuni_no_poison_every_ns_tier(pm):
    """The round-7 regression proper: the reference's default input class
    must complete on every NS tier (no canary) and pass the acceptance
    criteria.  Pre-fix, all four POISONED at 512 and 1024 alike."""
    a = _posuni(512, 512, 7)
    Q, R = block_qr(jnp.asarray(a), 64, POLICY_MIXED, panel_method=pm,
                    check="defer")
    Rn = np.asarray(R, np.float32)
    assert np.isfinite(Rn[0, 0]), f"{pm} poisoned on positive-uniform input"
    rep = metrics.evaluate(a, np.asarray(Q, np.float32), Rn,
                           precision_bits=8)
    assert rep.all_ok


def test_posuni_flagship_shape_group_kernel_path():
    """The original on-chip reproducer's shape class (1024^2 r=128 — the
    group-kernel configuration) on the interpret path."""
    a = _posuni(1024, 1024, 2)
    Q, R = block_qr(jnp.asarray(a), 128, POLICY_MIXED, panel_method="bgs1",
                    check="defer")
    Rn = np.asarray(R, np.float32)
    assert np.isfinite(Rn[0, 0])
    rep = metrics.evaluate(a, np.asarray(Q, np.float32), Rn,
                           precision_bits=8)
    assert rep.all_ok
