"""Mixed-precision dtype policies.

The reference implements its precision boundary as an explicit cast kernel
(``dev_cpy_and_cast_array``, ``Cuda/mmult.cuh:169-200``) feeding an FP16
TensorCore GEMM with FP32 accumulation (``dev_tensorcore_mmult_tiled``,
``Cuda/mmult.cuh:252-300``).  Here the same boundary is a dtype policy: cast
GEMM *inputs* to bf16 and accumulate in fp32 via ``preferred_element_type`` —
XLA hands such products to cuBLAS on the tensor cores, so no pad-to-16 /
cast-kernel machinery is needed (the compiler lays out tiles).

bf16 has an 8-bit mantissa vs fp16's 11-bit, so the mixed-precision error
acceptance bound is recalibrated: the reference uses ``2^-11 * m``
(``Cuda/qr.cu:1889``); the bf16 path documents/uses ``2^-8 * m``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Where each stage of blocked QR computes, and at what precision.

    Attributes:
        panel: dtype of the sequential panel factorization (reflector
            generation and T accumulation). The reference always keeps this
            fp32 on the host (``Cuda/qr.cu:1080``); we keep fp32 on device.
        trailing: GEMM *input* dtype for the trailing-matrix update
            ``C -= V (T^T (V^T C))``. fp32 in the reference's mixed path
            (``Cuda/qr.cu:1098``), bf16 in our flagship policy.
        q_update: GEMM input dtype for Q accumulation ``Q -= (Q V) T V^T``
            — the stage the reference runs on FP16 TensorCores
            (``Cuda/qr.cu:1191``).
        accum: accumulation/output dtype for all GEMMs
            (``preferred_element_type``); fp32 everywhere, mirroring the
            reference's FP32-accumulate wmma fragments.
        precision_bits: mantissa bits used in the ``2^-bits * m`` error
            acceptance criterion (``Cuda/qr.cu:115-127``): 23 for fp32 paths,
            11 for the reference fp16 path, 8 for bf16.
    """

    panel: Any = jnp.float32
    trailing: Any = jnp.float32
    q_update: Any = jnp.float32
    accum: Any = jnp.float32
    precision_bits: int = 23
    # Storage dtype of the accumulated Q between panel updates (None =
    # accum).  bf16 halves Q's HBM traffic — the dominant cost of complete-Q
    # factorizations at m >= 8192 (+23% measured at 8192) — at ~2^-8
    # orthogonality, which the mixed path already has.  The reference keeps
    # its master Q fp32 and casts per panel (Cuda/qr.cu:1148), so the
    # default POLICY_MIXED does too.
    q_store: Any = None

    @property
    def name(self) -> str:
        def _n(d):
            return jnp.dtype(d).name.replace("float", "f").replace("bfloat16", "bf16")

        return f"panel-{_n(self.panel)}_trail-{_n(self.trailing)}_q-{_n(self.q_update)}"


POLICY_FP32 = DTypePolicy()
# Flagship: fp32 panel + bf16 tensor-core GEMMs with fp32 accumulation.
POLICY_MIXED = DTypePolicy(
    trailing=jnp.bfloat16, q_update=jnp.bfloat16, precision_bits=8
)
# Everything-bf16 (panel too) — for error studies mirroring the reference's
# fp16 NaN investigation (python/performance_test_result/error.md).
POLICY_BF16 = DTypePolicy(
    panel=jnp.bfloat16, trailing=jnp.bfloat16, q_update=jnp.bfloat16,
    precision_bits=8,
)
# Mixed + bf16-resident Q: fastest complete-Q path for large m.
POLICY_MIXED_FAST = DTypePolicy(
    trailing=jnp.bfloat16, q_update=jnp.bfloat16, q_store=jnp.bfloat16,
    precision_bits=8,
)
# bf16-RESIDENT fast policy: the working matrix itself rides bf16 between
# panel updates (panel=bf16), plus bf16 Q storage.  At 2048^2 this LOSES
# (FLOP-bound regime; measured round-4) but at 8192+^2 the trailing-matrix
# HBM passes dominate (~4 GB fp32 at 8192) and halving them is the lever.
# Quality: one extra 2^-8 rounding per trailing write — same 2^-8*m
# acceptance class.
POLICY_BF16_FAST = DTypePolicy(
    panel=jnp.bfloat16, trailing=jnp.bfloat16, q_update=jnp.bfloat16,
    q_store=jnp.bfloat16, precision_bits=8,
)
# fp64 oracle policy (x64-enabled JAX; the reference's fp64 study
# column, performance_test_result/error.md).
POLICY_FP64 = DTypePolicy(
    panel=jnp.float64, trailing=jnp.float64, q_update=jnp.float64,
    accum=jnp.float64, precision_bits=52,
)


def policy_by_name(name: str) -> DTypePolicy:
    table = {
        "fp32": POLICY_FP32,
        "mixed": POLICY_MIXED,
        "mixed_fast": POLICY_MIXED_FAST,
        "bf16": POLICY_BF16,
        "bf16_fast": POLICY_BF16_FAST,
        "fp64": POLICY_FP64,
    }
    if name not in table:
        raise ValueError(f"unknown dtype policy {name!r}; options: {sorted(table)}")
    return table[name]


def matmul(
    a: jax.Array,
    b: jax.Array,
    *,
    in_dtype: Any = jnp.float32,
    accum_dtype: Any = jnp.float32,
    precision: Optional[jax.lax.Precision] = None,
) -> jax.Array:
    """Policy-aware matmul: the precision boundary of the framework.

    Casting the inputs is the analog of the reference's
    ``dev_cpy_and_cast_array`` fp32->fp16 boundary (``Cuda/qr.cu:1148-1163``);
    ``preferred_element_type=accum_dtype`` is the analog of its fp32
    accumulator fragments (``Cuda/mmult.cuh:276-299``).

    For fp32 inputs we request ``Precision.HIGHEST`` so XLA performs a true
    fp32 matmul instead of the default — one TF32 pass on a GPU, which
    would silently degrade the "fp32" paths the 2^-23*m acceptance bound
    assumes.
    """
    in_dtype = jnp.dtype(in_dtype)
    if precision is None:
        precision = (
            jax.lax.Precision.HIGHEST
            if in_dtype == jnp.float32
            else jax.lax.Precision.DEFAULT
        )
    a = a.astype(in_dtype)
    b = b.astype(in_dtype)
    return jnp.matmul(a, b, preferred_element_type=accum_dtype, precision=precision)


# Convenience partials used throughout the blocked drivers.
def trailing_matmul(policy: DTypePolicy):
    return partial(matmul, in_dtype=policy.trailing, accum_dtype=policy.accum)


def q_matmul(policy: DTypePolicy):
    return partial(matmul, in_dtype=policy.q_update, accum_dtype=policy.accum)
