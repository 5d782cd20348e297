"""Differentiable blocked QR — reverse-mode gradients for the framework's
factorization drivers.

The reference is a forward-only CUDA kernel suite; here the framework
lives inside JAX programs, where the factorization is routinely a step of a
larger differentiated computation (Gauss-Newton inner solves, bilevel
optimization over Jacobians, learned preconditioners).  This module makes
``qr`` a first-class citizen of ``jax.grad``: the primal runs ANY of the
blocked drivers (auto dispatch, the chain kernel, mixed policies — none
of which JAX could differentiate through), and the backward pass uses the
closed-form thin-QR adjoint, so the gradient costs two triangular solves
and a handful of GEMMs regardless of which driver produced Q, R.

Adjoint (m >= n, R nonsingular; Liao et al. 2019 "Differentiable
Programming Tensor Networks", the same formula LAPACK-backed frameworks
use): with ``A = Q R`` reduced and cotangents ``(gQ, gR)``,

    M   = R gR^T - gQ^T Q
    gA  = (gQ + Q copyltu(M)) R^{-T}

where ``copyltu`` copies the strict lower triangle onto the upper
(``copyltu(M) = tril(M,-1) + tril(M,-1)^T + diag(M)``).  The formula is
exact for the factorization CONVENTION the driver returns (sign choices
cancel: both Q and R flip together, and the adjoint only consumes them in
convention-invariant pairs).

Oracle-tested against ``jnp.linalg.qr``'s autodiff on sign-canonicalized
factors and against central finite differences (tests/test_autodiff.py).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from mixedprecisionblockqr_tpu.ops.policy import POLICY_FP32, DTypePolicy

__all__ = ["qr_autodiff", "make_differentiable_qr", "copyltu"]


def copyltu(M: jax.Array) -> jax.Array:
    """Copy the strict lower triangle of a square matrix onto its upper:
    ``tril(M, -1) + tril(M, -1)^T + diag(M)`` (the thin-QR adjoint's
    symmetrization)."""
    L = jnp.tril(M, -1)
    return L + L.T + jnp.diag(jnp.diag(M))


@functools.lru_cache(maxsize=None)
def make_differentiable_qr(
    block_size: int = 128,
    policy: DTypePolicy = POLICY_FP32,
    panel_method: str = "auto",
    quality: Optional[str] = None,
):
    """Build ``A -> (Q, R)`` (reduced mode) with a custom VJP.

    The primal is the public ``block_qr`` with ``check='defer'`` (no host
    sync — the NaN canary propagates into gradients, so a Newton-Schulz
    breakdown is loud in training loss too).  Cached per parameter tuple so
    repeated calls reuse one ``custom_vjp`` instance (and its jit cache).

    Gradients assume full column rank (R nonsingular) — the standard thin-QR
    differentiability domain.  The backward runs at fp32 HIGHEST regardless
    of the policy: gradients drive OPTIMIZATION, where bf16 projection noise
    compounds across steps (same reasoning as the reorth tiers' precision
    rule).
    """
    from mixedprecisionblockqr_tpu.ops.blockqr import block_qr

    hi = jax.lax.Precision.HIGHEST

    @jax.custom_vjp
    def qr_fn(A):
        return block_qr(
            A, block_size, policy, mode="reduced",
            panel_method=panel_method, quality=quality, check="defer",
        )

    def fwd(A):
        Q, R = qr_fn(A)
        # Zero-size token carries A's dtype so the returned cotangent
        # matches the primal input exactly (bf16 inputs included).
        return (Q, R), (Q, R, jnp.zeros((0,), A.dtype))

    def bwd(res, cotangents):
        Q, R, a_token = res
        gQ, gR = cotangents
        Q32 = Q.astype(jnp.float32)
        R32 = R.astype(jnp.float32)
        gQ32 = gQ.astype(jnp.float32)
        gR32 = gR.astype(jnp.float32)
        M = (
            jnp.matmul(R32, gR32.T, precision=hi)
            - jnp.matmul(gQ32.T, Q32, precision=hi)
        )
        Y = gQ32 + jnp.matmul(Q32, copyltu(M), precision=hi)
        # gA = Y R^{-T}  <=>  solve R^T X^T = Y^T  (lower-triangular solve).
        gA = jax.lax.linalg.triangular_solve(
            R32, Y, left_side=False, lower=False, transpose_a=True,
        )
        return (gA.astype(a_token.dtype),)

    qr_fn.defvjp(fwd, bwd)
    return qr_fn


def qr_autodiff(
    A: jax.Array,
    block_size: int = 128,
    policy: DTypePolicy = POLICY_FP32,
    panel_method: str = "auto",
    quality: Optional[str] = None,
):
    """Reduced QR with reverse-mode gradients: ``Q, R = qr_autodiff(A)``
    participates in ``jax.grad``/``jax.vjp`` like any JAX primitive.

    Use inside differentiated programs where ``mixedprecisionblockqr_tpu.qr``
    (forward-only drivers) would fail to trace a gradient.  Composes with
    triangular solves for differentiable least squares::

        def loss(A, b):
            Q, R = qr_autodiff(A)
            x = jax.scipy.linalg.solve_triangular(R, Q.T @ b, lower=False)
            return jnp.sum((x - target) ** 2)
        gA, gb = jax.grad(loss, argnums=(0, 1))(A, b)
    """
    return make_differentiable_qr(block_size, policy, panel_method, quality)(A)
