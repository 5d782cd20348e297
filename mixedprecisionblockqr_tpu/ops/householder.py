"""Householder reflector generation and unblocked QR — pure JAX.

Capabilities mirrored from the reference (behavior, not code):
  * reflector construction with the cancellation-avoiding sign convention
    sign(x_k)*||x||*e_k (``python/qr.py:7-24``, ``Cuda/qr.cu:211-257``),
  * zero-column skip (``python/qr.py:50-52``, ``Cuda/qr.cu:242-244``),
  * unblocked Householder QR, Golub & Van Loan Alg. 5.2.1
    (``Cuda/qr.cu:198-293``), with ``reduced``/``complete``/``raw`` modes
    matching ``python/qr.py:26-71``,
  * Q backward accumulation, GVL Alg. 5.1.5 (``Cuda/qr.cu:296-335``).

Design: everything is static-shaped.  Reflectors are full-length
vectors masked with ``iota >= k`` instead of the reference's shrinking
``(m-k)``-length slices, so the entire column loop is a single
``lax.fori_loop`` that XLA compiles once — no dynamic shapes, no host round
trips.  Reflectors use the unit-norm convention (beta == 2 for every live
column), matching the reference's WY semantics (``Cuda/qr.cu:351``,
``python/qr.py:57-58``).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST

def _mm(a, b):
    # fp32-true matmul/matvec: the default fp32 matmul precision is a single
    # reduced-precision pass (TF32 on a GPU); the panel math needs fp32.
    return jnp.matmul(a, b, precision=_HI)


_EPS_BY_DTYPE = {
    jnp.dtype(jnp.float64): 1e-300,
    jnp.dtype(jnp.float32): 1e-30,
    jnp.dtype(jnp.bfloat16): 1e-30,
    jnp.dtype(jnp.float16): 1e-6,
}


def _tiny(dtype) -> float:
    return _EPS_BY_DTYPE.get(jnp.dtype(dtype), 1e-30)


def householder_reflector(x: jax.Array, k) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Unit-norm Householder reflector annihilating x[k+1:], masked below k.

    Returns ``(w, beta, rkk)`` with ``H = I - beta * w w^T`` (beta is 2 for a
    live column, 0 for a numerically-zero column — the skip case), ``w`` is
    zero in rows < k, and ``H x = rkk * e_k`` on rows >= k.

    Matches the reference's convention (``python/qr.py:7-24``): for
    ``x = [0,0,2]`` (k=0) the reflector maps x to ``[-2,0,0]``, i.e.
    ``rkk = -sign(x_k) * ||x||``.
    """
    m = x.shape[0]
    dtype = x.dtype
    rows = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)[:, 0]
    mask = rows >= k
    xm = jnp.where(mask, x, jnp.zeros_like(x))
    sigma = jnp.sqrt(jnp.sum(xm * xm))

    alpha = jnp.sum(jnp.where(rows == k, x, jnp.zeros_like(x)))
    sign = jnp.where(alpha >= 0, jnp.array(1, dtype), jnp.array(-1, dtype))

    e_k = (rows == k).astype(dtype)
    u = xm + sign * sigma * e_k
    # ||u||^2 = 2 sigma (sigma + |alpha|); computed directly for stability.
    unorm = jnp.sqrt(jnp.sum(u * u))

    live = sigma > _tiny(dtype)
    safe_unorm = jnp.where(live, unorm, jnp.ones_like(unorm))
    w = jnp.where(live, u / safe_unorm, jnp.zeros_like(u))
    beta = jnp.where(live, jnp.array(2.0, dtype), jnp.array(0.0, dtype))
    rkk = jnp.where(live, -sign * sigma, alpha)
    return w, beta, rkk


def _num_reflectors(m: int, n: int) -> int:
    # Skip the last column of a square matrix (its reflector is a trivial
    # sign flip) — same loop bound the reference uses (python/qr.py:47-49).
    return min(m - 1, n) if m > 1 else 0


@jax.jit
def _householder_qr_impl(A: jax.Array):
    m, n = A.shape
    dtype = A.dtype
    K = _num_reflectors(m, n)

    def body(k, carry):
        A, V, beta = carry
        w, b, _ = householder_reflector(A[:, k], k)
        # Rank-1 update A <- (I - b w w^T) A. Full-width: columns < k have
        # (numerically) zero support on rows >= k, so they are unchanged up
        # to rounding — this keeps every iteration identically shaped.
        wtA = _mm(w, A)                  # (n,)
        A = A - b * jnp.outer(w, wtA)
        V = V.at[:, k].set(w)
        beta = beta.at[k].set(b)
        return A, V, beta

    V0 = jnp.zeros((m, max(K, 1)), dtype)
    beta0 = jnp.zeros((max(K, 1),), dtype)
    A_out, V, beta = jax.lax.fori_loop(0, K, body, (A, V0, beta0))
    return A_out, V, beta


@jax.jit
def q_backward_accumulation(V: jax.Array, beta: jax.Array) -> jax.Array:
    """Accumulate full Q from stored reflectors, right-to-left (GVL 5.1.5).

    On-device form of ``h_q_backward_accumulation`` (``Cuda/qr.cu:296-335``):
    a single ``fori_loop`` of masked rank-1 updates instead of per-column
    host loops.
    """
    m, K = V.shape
    dtype = V.dtype
    Q0 = jnp.eye(m, dtype=dtype)

    def body(i, Q):
        k = K - 1 - i
        w = V[:, k]
        b = beta[k]
        return Q - b * jnp.outer(w, _mm(w, Q))

    return jax.lax.fori_loop(0, K, body, Q0)


def householder_qr(A, mode: str = "reduced", dtype=jnp.float32):
    """Unblocked Householder QR.  Modes mirror ``python/qr.py:26-71``:

    * ``'reduced'``  -> (Q[:, :n], R[:n, :])
    * ``'complete'`` -> (Q (m x m), R (m x n))
    * ``'raw'``      -> (V, beta): unit reflectors (columns of V) and betas
      such that Q = H_0 H_1 ... H_{K-1}, H_k = I - beta_k v_k v_k^T.
    """
    A = jnp.asarray(A, dtype=dtype)
    m, n = A.shape
    R_full, V, beta = _householder_qr_impl(A)
    if mode == "raw":
        return V, beta
    # Zero the sub-diagonal rounding residue so R is exactly triangular.
    R_full = jnp.triu(R_full)
    Q = q_backward_accumulation(V, beta)
    if mode == "reduced":
        return Q[:, :n], R_full[:n, :]
    if mode == "complete":
        return Q, R_full
    raise ValueError(f"unknown mode {mode!r}")


def panel_factor(
    panel: jax.Array, num_cols: int | None = None
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Factor an (h x r) panel: returns (V, T, R_panel) with
    ``Q_panel = I - V T V^T`` (compact-WY, forward product) and
    ``R_panel = Q_panel^T @ panel`` upper-triangular in its top r rows.

    This is the device-side unification of the reference's host panel
    factorization (``h_householder_qr``, ``Cuda/qr.cu:198``) and WY
    accumulation (``h_wy_transform``/``dev_wy_transform``,
    ``Cuda/qr.cu:337-600``).  We accumulate the storage-efficient T factor
    (r x r upper-triangular) instead of the dense (m x m) ``I - W Y^T`` the
    reference materializes per panel; tests verify the W = V T equivalence.

    ``num_cols`` masks trailing panel columns (for a final narrow panel run
    through a fixed-width kernel); defaults to the full width.
    """
    h, r = panel.shape
    dtype = panel.dtype
    ncols = r if num_cols is None else num_cols

    def body(j, carry):
        P, V, T = carry
        w, b, _ = householder_reflector(P[:, j], j)
        wtP = _mm(w, P)
        P = P - b * jnp.outer(w, wtP)
        # T update (forward product): T[:, j] = -b * T @ (V^T w); T[j, j] = b.
        # V has zeros in columns >= j and T outside its top-left j x j block,
        # so full-size ops compute exactly the incremental column.
        tcol = -b * _mm(T, _mm(V.T, w))
        V = V.at[:, j].set(w)
        T = T.at[:, j].set(tcol)
        T = T.at[j, j].set(b)
        return P, V, T

    V0 = jnp.zeros((h, r), dtype)
    T0 = jnp.zeros((r, r), dtype)
    P, V, T = jax.lax.fori_loop(0, ncols, body, (panel, V0, T0))
    return V, T, P
