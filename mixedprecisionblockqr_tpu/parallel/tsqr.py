"""TSQR — communication-avoiding tall-skinny QR with a binary reduction tree.

Completes and generalizes the reference's NumPy prototype
(``ts_qr``, ``python/ca_qr.py:25-43``): the prototype hard-codes a 4-way row
split and materializes full (h x h) leaf Qs; its tiled driver abandons Q
reconstruction ("need fix Q", ``python/ca_qr.py:73-75``).  Here:

  * arbitrary power-of-two leaf counts, rows padded as needed,
  * leaves and tree nodes are compact-WY panel factorizations (V, T) —
    reduced Q factors only, never h x h,
  * every tree level is one ``vmap``-batched panel QR (all pairs in a level
    factor simultaneously),
  * full Q reconstruction by a top-down sweep of (n x n) path factors,
  * a mesh-sharded variant (``tsqr_sharded``): local leaf QR per device,
    one ``all_gather`` of the tiny (n x n) R factors, redundant
    replicated tree, local Q fix-up — the standard single-collective TSQR.

Rank caveat: Q reconstruction assumes the leaf R factors are nonsingular
(full-rank A).  Rank-deficient inputs still produce a valid R and residual
A = QR, matching the reference's behavior on its rank-deficient fixtures.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from mixedprecisionblockqr_tpu.ops.cholqr import cholesky_qr2
from mixedprecisionblockqr_tpu.ops.householder import panel_factor
from mixedprecisionblockqr_tpu.ops.wy import reduced_q_from_vt
from mixedprecisionblockqr_tpu.parallel.mesh import ROWS_AXIS

_HI = jax.lax.Precision.HIGHEST


LEAF_METHODS = ("householder", "cholqr2", "cholqr2s")


def _leaf_qr(
    block: jax.Array, method: str = "householder"
) -> Tuple[jax.Array, jax.Array]:
    """Reduced QR of one (h x n) leaf: returns (Q (h x n), R (n x n)).

    method='cholqr2' is the all-GEMM fast path (see ops/cholqr.py) — for
    tall-skinny leaves it is both faster and much cheaper to compile than
    the sequential reflector loop; 'cholqr2s' is the shifted variant
    (Fukaya et al. 2020) whose domain extends to cond ~ 1/eps_f32 —
    the robust all-GEMM choice for ill-conditioned leaves;
    'householder' is the unconditionally robust default.
    """
    h, n = block.shape
    if method in ("cholqr2", "cholqr2s"):
        return cholesky_qr2(block, shifted=method == "cholqr2s")
    V, T, Rf = panel_factor(block)
    return reduced_q_from_vt(V, T, n), jnp.triu(Rf[:n, :])


def reduction_tree(
    Rs: jax.Array, method: str = "householder"
) -> Tuple[jax.Array, jax.Array]:
    """Binary-tree QR of L stacked (n x n) R factors.

    Given ``Rs`` of shape (L, n, n) (L a power of two), computes the QR of the
    (L*n x n) vertical stack and returns ``(F, R)`` where ``R`` is the global
    (n x n) triangular factor and ``F`` is (L, n, n) path factors such that

        vstack(Rs) = vstack(F_0, ..., F_{L-1}) @ R   with  vstack(F) orthonormal.

    Each level batches all pair-QRs with ``vmap`` (the reference's explicit
    U12/U34/U1234 tree, ``python/ca_qr.py:33-41``, generalized).
    """
    L, n, _ = Rs.shape
    if L < 1 or L & (L - 1):
        raise ValueError(
            f"reduction_tree requires a power-of-two leaf count, got {L} "
            "(pad the R stack or pick n_leaves/mesh-axis sizes of 2^k)"
        )
    level_qs = []
    cur = Rs
    c = L
    while c > 1:
        pairs = cur.reshape(c // 2, 2 * n, n)
        if method == "cholqr2":
            Qp, Rn_ = jax.vmap(cholesky_qr2)(pairs)
            cur = Rn_
        else:
            Vp, Tp, Rp = jax.vmap(panel_factor)(pairs)
            Qp = jax.vmap(lambda v, t: reduced_q_from_vt(v, t, n))(Vp, Tp)
            cur = jnp.triu(Rp[:, :n, :])
        level_qs.append(Qp)  # (c//2, 2n, n)
        c //= 2
    R = cur[0]
    # Top-down reconstruction of the per-leaf path factors.
    F = jnp.eye(n, dtype=Rs.dtype)[None]  # (1, n, n)
    for Qp in reversed(level_qs):
        top = jnp.einsum("cij,cjk->cik", Qp[:, :n, :], F, precision=_HI)
        bot = jnp.einsum("cij,cjk->cik", Qp[:, n:, :], F, precision=_HI)
        F = jnp.stack([top, bot], axis=1).reshape(-1, n, n)
    return F, R


def _check_leaf_height(m: int, L: int, n: int, ctx: str) -> None:
    """Leaves must be at least n tall: a short leaf's QR has rank < n and
    the tree silently propagates the defect — cholqr leaves return
    ALL-NaN factors (no canary, no error) and householder leaves crash
    with an opaque broadcast error (review finding, verified at
    256x64 / 8 leaves).  Same rule CAQR enforces for its row blocks."""
    h = -(-m // L)
    if h < n:
        raise ValueError(
            f"{ctx}: leaf height ceil({m}/{L}) = {h} is shorter than the "
            f"panel width n = {n}; use at most {max(m // n, 1)} leaves "
            "(short leaves are rank-deficient and the reduction tree "
            "propagates the defect silently)"
        )


def _pick_leaves(m: int, n: int, n_leaves: Optional[int]) -> int:
    if n_leaves is not None:
        return n_leaves
    L = 1
    # Largest power of two keeping leaves at least ~4n tall (tree nodes are
    # 2n x n; leaves shorter than n are degenerate).
    while L * 2 <= 64 and (m + L * 2 - 1) // (L * 2) >= max(4 * n, 32):
        L *= 2
    return L


@partial(jax.jit, static_argnames=("n_leaves", "method"))
def _tsqr_impl(A: jax.Array, n_leaves: int, method: str = "householder"):
    m, n = A.shape
    L = n_leaves
    h = -(-m // L)  # ceil
    pad = L * h - m
    Ap = jnp.pad(A, ((0, pad), (0, 0))) if pad else A
    blocks = Ap.reshape(L, h, n)
    Qs, Rs = jax.vmap(lambda b: _leaf_qr(b, method))(blocks)
    F, R = reduction_tree(Rs, method)            # (L, n, n), (n, n)
    Qb = jnp.einsum("lhj,ljk->lhk", Qs, F, precision=_HI)
    Q = Qb.reshape(L * h, n)
    return Q[:m, :], R


def tsqr(
    A, n_leaves: Optional[int] = None, method: str = "householder"
) -> Tuple[jax.Array, jax.Array]:
    """Reduced QR of a tall-skinny matrix via TSQR.  A: (m, n), m >> n.

    method: 'householder' (robust), 'cholqr2' (all-GEMM fast path), or
    'cholqr2s' (shifted CholeskyQR — all-GEMM and safe to cond ~ 1/eps_f32;
    use for ill-conditioned tall-skinny problems where plain cholqr2's
    Gram-squared domain, cond <~ 4e3 in fp32, is exceeded).
    With a cholqr method and no explicit leaf count, the single-device
    direct factorization (L=1, no tree) is used — on one device the tree
    only adds passes over the data; the reduction tree earns its keep across devices
    (``tsqr_sharded``) or for Householder-leaf robustness.
    Returns (Q (m x n), R (n x n)).
    """
    A = jnp.asarray(A, dtype=jnp.float32)
    m, n = A.shape
    if m < n:
        raise ValueError(f"tsqr requires m >= n, got {A.shape}")
    if method not in LEAF_METHODS:
        raise ValueError(f"unknown tsqr method {method!r}; options: {LEAF_METHODS}")
    if n_leaves is not None and (n_leaves < 1 or n_leaves & (n_leaves - 1)):
        raise ValueError(
            f"n_leaves must be a power of two, got {n_leaves} "
            "(the binary reduction tree pairs leaves level by level)"
        )
    if n_leaves is None and method.startswith("cholqr"):
        return _leaf_qr(A, method)
    L = _pick_leaves(m, n, n_leaves)
    if L == 1:
        return _leaf_qr(A, method)
    _check_leaf_height(m, L, n, "tsqr")
    return _tsqr_impl(A, L, method)


def tsqr_batched(A_batch, n_leaves: Optional[int] = None):
    """Batched TSQR over a leading batch axis (DP-analog; ``vmap``)."""
    if n_leaves is not None and (n_leaves < 1 or n_leaves & (n_leaves - 1)):
        raise ValueError(f"n_leaves must be a power of two, got {n_leaves}")
    L = _pick_leaves(A_batch.shape[1], A_batch.shape[2], n_leaves)
    if L == 1:
        return jax.vmap(_leaf_qr)(A_batch)
    _check_leaf_height(A_batch.shape[1], L, A_batch.shape[2],
                       "tsqr_batched")
    return jax.vmap(lambda a: _tsqr_impl(a, L))(A_batch)


def tsqr_sharded(
    A: jax.Array,
    mesh: Mesh,
    axis: str = ROWS_AXIS,
    local_leaves: int = 1,
) -> Tuple[jax.Array, jax.Array]:
    """Mesh-sharded TSQR: A row-sharded over ``mesh[axis]``; returns
    (Q row-sharded like A, R replicated).

    Communication: ONE ``all_gather`` of the (n x n) local R factors over the
    mesh axis — O(d * n^2) bytes — after which every device runs the tiny
    reduction tree redundantly (deterministic, replicated) and fixes up its
    local Q block with its own path factor.  This is the communication
    pattern the reference's single-GPU prototype cannot express.
    """
    A = jnp.asarray(A, dtype=jnp.float32)
    m, n = A.shape
    d = mesh.shape[axis]
    if m % d != 0:
        raise ValueError(f"rows {m} must divide over mesh axis {axis} ({d})")
    if d & (d - 1):
        raise ValueError(
            f"tsqr_sharded needs a power-of-two mesh axis {axis!r}, got {d} "
            "(the replicated binary reduction tree pairs device R factors)"
        )
    if local_leaves < 1 or local_leaves & (local_leaves - 1):
        raise ValueError(f"local_leaves must be a power of two, got {local_leaves}")
    _check_leaf_height(m, d * local_leaves, n, "tsqr_sharded")

    def local_fn(Ablk):
        # Ablk: (m/d, n) local block.
        if local_leaves > 1:
            Qloc, Rloc = _tsqr_impl(Ablk, local_leaves)
        else:
            Qloc, Rloc = _leaf_qr(Ablk)
        Rall = jax.lax.all_gather(Rloc, axis)    # (d, n, n), replicated value
        F, R = reduction_tree(Rall)
        my = jax.lax.axis_index(axis)
        myF = jax.lax.dynamic_index_in_dim(F, my, axis=0, keepdims=False)
        Qfix = jnp.matmul(Qloc, myF, precision=_HI)
        return Qfix, R

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=P(axis, None),
        out_specs=(P(axis, None), P()),
        # fori_loop carries inside panel_factor start replicated and become
        # device-varying; skip the static varying-axes check (the tree result
        # is deterministic-replicated by construction).
        check_vma=False,
    )
    return jax.jit(fn)(A)
