"""The triangular Newton-Schulz chain as one GPU kernel (Pallas on Triton).

A Block Gram-Schmidt panel factorization is two tall GEMMs (the Gram
``G = P^T P`` and ``Q = P X``) around an r x r chain of 20-60 small
dependent products (``ops/polar.py::tri_inv_chol``: ~3 products per
iteration over 6-14 iterations, plus the scaling and the spectral guard).
XLA runs each of those products as its own kernel.  This kernel runs the
whole chain — Jacobi scaling, spectral guard, every iteration, the R
recovery ``t = triu(X^T G)`` and the convergence residual — in ONE program
that holds the r x r operands on one SM (16 KB per fp32 matrix at r=64).

Precision: Triton lowers a float32 ``HIGHEST`` dot to IEEE FMAs on the CUDA
cores, and ``DEFAULT``/``HIGH`` to a single TF32 pass (~10 mantissa bits).
Every product here is instead the three-pass TF32 split
``a_hi b_hi + a_hi b_lo + a_lo b_hi`` (``DotAlgorithmPreset.
TF32_TF32_F32_X3``, which Triton splits in registers): fp32-class accuracy
from the tensor cores.  CPU XLA has no TF32, so in interpret mode the same
three products are written out (``_dot3_emulated``).

Semantics match ``ops/polar.py::tri_chain`` (same seed, guard, update and
residual convention); the two agree to fp32 roundoff.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_DN_TA = (((0,), (0,)), ((), ()))  # a^T b: contract both operands' axis 0
NUM_WARPS = 8


def _split_tf32(a):
    # a = hi + lo with hi exactly representable in TF32 (top 10 explicit
    # mantissa bits: clear the low 13) and |lo| <= 2^-10 |a|.
    bits = jax.lax.bitcast_convert_type(a, jnp.int32)
    hi = jax.lax.bitcast_convert_type(bits & jnp.int32(-8192), jnp.float32)
    return hi, a - hi


def _dot3_emulated(a, b, dimension_numbers):
    # The dropped lo*lo term is ~2^-20 relative: fp32-roundoff class.
    ah, al = _split_tf32(a)
    bh, bl = _split_tf32(b)
    dot = functools.partial(jax.lax.dot_general,
                            dimension_numbers=dimension_numbers,
                            preferred_element_type=jnp.float32)
    return dot(ah, bh) + (dot(ah, bl) + dot(al, bh))


def _dot3(a, b, dimension_numbers, emulate=False):
    if emulate:
        return _dot3_emulated(a, b, dimension_numbers)
    return jax.lax.dot_general(
        a, b, dimension_numbers,
        precision=jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3,
        preferred_element_type=jnp.float32)


def _dot(a, b, emulate=False):
    return _dot3(a, b, (((1,), (0,)), ((), ())), emulate)


def _dot_ta(a, b, emulate=False):
    return _dot3(a, b, _DN_TA, emulate)


def _norm2_est(M):
    # Upper estimate of ||M||_2 for SYMMETRIC M, scale-normalized (mirror of
    # ops/polar.py::_spectral_guard).  The two power-iteration matvecs are
    # broadcast multiplies and reductions: a tensor-core dot needs every
    # operand dimension >= 16, and symmetry lets the row- and column-shaped
    # vectors alternate without a transpose.
    a = jnp.maximum(jnp.max(jnp.abs(M)), jnp.finfo(jnp.float32).tiny)
    Ms = M * (1.0 / a)
    v0 = jnp.sum(Ms, axis=0, keepdims=True)                  # (1, r)
    v1 = jnp.sum(Ms * v0, axis=1, keepdims=True)             # (r, 1)
    n1 = jnp.sqrt(jnp.sum(v1 * v1))
    v2 = jnp.sum(Ms * (v1 * (1.0 / (n1 + 1e-30))), axis=0, keepdims=True)
    return (1.05 * a) * jnp.sqrt(jnp.sum(v2 * v2))


def _ns_kernel(g_ref, x_ref, t_ref, resid_ref, *, r: int, iters: int,
               shift: float, refine: bool, omega: bool, emulate: bool):
    dot = functools.partial(_dot, emulate=emulate)
    dot_ta = functools.partial(_dot_ta, emulate=emulate)
    rows = jax.lax.broadcasted_iota(jnp.int32, (r, r), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (r, r), 1)
    eye = (rows == cols).astype(jnp.float32)
    G = g_ref[...]
    if shift:
        # G + s||G|| I caps the effective condition number so a fixed chain
        # converges for any input (the robust panel's first pass).
        G = G + (shift * _norm2_est(G)) * eye
    if refine:
        X = eye  # G already near identity: no scaling, no guard
    else:
        diag = jnp.where(rows == cols, G, 0.0)
        tiny = jnp.finfo(jnp.float32).tiny
        dcol = jax.lax.rsqrt(jnp.maximum(jnp.sum(diag, axis=1, keepdims=True),
                                         tiny))
        drow = jax.lax.rsqrt(jnp.maximum(jnp.sum(diag, axis=0, keepdims=True),
                                         tiny))
        scale = jax.lax.rsqrt(_norm2_est(G * dcol * drow))
        X = jnp.where(rows == cols, drow * scale, 0.0)
    # Over-relaxed early iterations (ops/polar.py::ns_omega_iters).
    n_om = 0 if (refine or not omega) else min(4, max(0, iters - 4))
    E = eye
    for it in range(iters):  # static unroll: iters is a Python int
        W = dot(G, X)
        E = eye - dot_ta(X, W)
        C = jnp.where(cols > rows, E, 0.0) + jnp.where(rows == cols, E, 0.0) * 0.5
        X = X + (1.5 if it < n_om else 1.0) * dot(X, C)
    if refine:
        # Refine chains close the robust composition and feed the poison
        # canary: report the exact post-loop residual, not the one-behind.
        E = eye - dot_ta(X, dot(G, X))
    x_ref[...] = X
    # X^{-1} = X^T G at convergence: R recovered with no solve.
    t_ref[...] = jnp.where(cols >= rows, dot_ta(X, G), 0.0)
    resid_ref[...] = jnp.max(jnp.abs(E), axis=0)


def kernel_fits(r: int) -> bool:
    """Widths the kernel compiles at: a power of two (Triton blocks) of at
    least 16 (tensor-core dot operands) and at most 64 — at r=128 Triton's
    fp32 dot-operand buffers ask 256 KB of shared memory, more than the
    227 KB one H100 block may use, whatever the product's precision."""
    return 16 <= r <= 64 and r & (r - 1) == 0


@functools.partial(
    jax.jit, static_argnames=("iters", "shift", "refine", "omega", "interpret")
)
def ns_chain(
    G: jax.Array,
    iters: int = 10,
    shift: float = 0.0,
    refine: bool = False,
    omega: bool = True,
    interpret: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Triangular-NS inverse Cholesky of an SPD Gram ``G`` (r x r) as one
    kernel.

    Returns ``(X, t, resid)``: upper-triangular X with ``X^T G' X ~= I``
    (G' = G + shift*||G|| I when ``shift`` > 0), ``t = triu(X^T G')`` (the
    inverse of X at convergence), and ``resid = max|I - X^T G' X|`` from the
    last iteration's correction (one step behind, free) — or, with
    ``refine=True`` (identity-seeded chain for Grams already near I), the
    exact post-loop residual.  ``r`` must satisfy ``kernel_fits``.
    """
    r = G.shape[0]
    if not kernel_fits(r):
        raise ValueError(f"ns_chain needs a power-of-two r in [16, 64], got {r}")
    kernel = functools.partial(_ns_kernel, r=r, iters=iters, shift=shift,
                               refine=refine, omega=omega, emulate=interpret)
    X, t, resid = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((r, r), jnp.float32),
            jax.ShapeDtypeStruct((r, r), jnp.float32),
            jax.ShapeDtypeStruct((r,), jnp.float32),
        ),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="ns_chain",
    )(G.astype(jnp.float32))
    return X, t, jnp.max(resid)
