"""WY / compact-WY (T-matrix) block-reflector representations.

The reference builds the dense ``I - W Y^T`` panel-Q explicitly, on host
(``h_wy_transform``, GVL Alg 5.1.2, ``Cuda/qr.cu:337-426``) and on device via
four kernels per panel column (``dev_wy_transform``, ``Cuda/qr.cu:535-600``).
We store the compact-WY *T factor* instead — ``Q = I - V T V^T`` with T
(r x r) upper triangular — which is O(r^2) storage vs the reference's
O((m-offset)^2) dense panel-Q, and lets every application of the block
reflector be three GEMMs.  ``wy_representation`` recovers the reference's
(W, Y) = (V T, V) form exactly (beta = 2 unit-norm reflectors,
``Cuda/qr.cu:351``) for parity tests.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from mixedprecisionblockqr_tpu.ops.policy import DTypePolicy, POLICY_FP32, matmul

_HI = jax.lax.Precision.HIGHEST


@jax.jit
def build_t_matrix(V: jax.Array, beta: jax.Array) -> jax.Array:
    """Build the upper-triangular T with ``H_0 ... H_{r-1} = I - V T V^T``.

    Forward-product recurrence (the T-form of GVL Alg 5.1.2, which the
    reference implements in W-form at ``python/wy.py:3-27``):
        T_0 = [beta_0];  T_j = [[T, -beta_j T (V^T v_j)], [0, beta_j]].
    """
    h, r = V.shape
    dtype = V.dtype
    # S = V^T V once (r x r), then a scan builds columns of T.
    S = jnp.matmul(V.T, V, precision=_HI)

    def body(j, T):
        tcol = -beta[j] * jnp.matmul(T, S[:, j], precision=_HI)
        cols = jax.lax.broadcasted_iota(jnp.int32, (r, 1), 0)[:, 0]
        tcol = jnp.where(cols < j, tcol, jnp.zeros_like(tcol))
        T = T.at[:, j].set(tcol)
        T = T.at[j, j].set(beta[j])
        return T

    return jax.lax.fori_loop(0, r, body, jnp.zeros((r, r), dtype))


def wy_representation(V: jax.Array, beta: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Return (W, Y) with ``Q = I - W Y^T`` — the reference's form
    (``python/wy.py:3-27``).  Y = V and W = V T."""
    T = build_t_matrix(V, beta)
    W = jnp.matmul(V, T, precision=_HI)
    return W, V


def apply_block_reflector_left_t(
    C: jax.Array,
    V: jax.Array,
    T: jax.Array,
    policy: DTypePolicy = POLICY_FP32,
) -> jax.Array:
    """C <- Q^T C = C - V (T^T (V^T C)): the trailing-matrix update.

    On-device replacement for the reference's
    ``shared_mem_mmult_in_place_transpose_a`` hot kernel
    (``Cuda/mmult.cu:237-288``, launched at ``Cuda/qr.cu:1098``): three
    GEMMs under the policy's trailing dtype with fp32 accumulation.
    """
    mm = lambda a, b: matmul(a, b, in_dtype=policy.trailing, accum_dtype=policy.accum)
    VtC = mm(V.T, C)
    TtVtC = jnp.matmul(
        T.T.astype(policy.accum), VtC, precision=_HI
    )  # r x r — tiny, keep fp32
    return C - mm(V, TtVtC)


def reduced_q_from_vt(V: jax.Array, T: jax.Array, n: int | None = None) -> jax.Array:
    """First n columns of ``Q = I - V T V^T`` without materializing the h x h
    identity: ``Q[:, :n] = I[:, :n] - V (T V[:n, :]^T)``.  Two small GEMMs —
    the TSQR leaf-Q builder."""
    h, r = V.shape
    n = r if n is None else n
    Tt = jnp.matmul(T, V[:n, :].T, precision=_HI)  # r x n
    Q = -jnp.matmul(V, Tt, precision=_HI)
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, n), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, n), 1)
    return Q + (rows == cols).astype(Q.dtype)


def apply_block_reflector_right(
    Q: jax.Array,
    V: jax.Array,
    T: jax.Array,
    policy: DTypePolicy = POLICY_FP32,
) -> jax.Array:
    """Q <- Q (I - V T V^T) = Q - ((Q V) T) V^T: the Q-accumulation update.

    This is the stage the reference casts to FP16 and runs on TensorCores
    (``dev_tensorcore_mmult_tiled`` launch, ``Cuda/qr.cu:1191``); here it is
    bf16 tensor-core GEMMs with fp32 accumulation under POLICY_MIXED.
    """
    mm = lambda a, b: matmul(a, b, in_dtype=policy.q_update, accum_dtype=policy.accum)
    QV = mm(Q, V)
    QVT = jnp.matmul(QV, T.astype(policy.accum), precision=_HI)
    return Q - mm(QVT, V.T)
