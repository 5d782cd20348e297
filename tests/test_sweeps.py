"""Sweep-iterator tests — the reference's geometric sweeps over problem
shapes, panel widths, offsets, and dtype combos
(``test_iterator_dev_wy_funcs`` ``Cuda/qr.cu:1910-1942``,
``test_iterator_template_tensorcore_mmult_tiled`` ``Cuda/qr.cu:1944-1959``),
kept small enough for CI."""

import jax.numpy as jnp
import numpy as np
import pytest

from mixedprecisionblockqr_tpu.ops import metrics
from mixedprecisionblockqr_tpu.ops.blockqr import block_qr
from mixedprecisionblockqr_tpu.ops.householder import panel_factor
from mixedprecisionblockqr_tpu.ops.policy import POLICY_FP32, POLICY_MIXED
from mixedprecisionblockqr_tpu.utils.datagen import size_sweep


def test_wy_panel_sweep():
    """Geometric sweep over (m, panel width): WY factors must reconstruct
    the orthogonal panel across the grid (the dev_wy sweep's role)."""
    rng = np.random.default_rng(0)
    for m in (16, 32, 64, 128):
        for w in (2, 4, 8):
            if w > m // 2:
                continue
            P = rng.random((m, w)).astype(np.float32)
            V, T, Rf = panel_factor(jnp.asarray(P))
            Vn, Tn = np.asarray(V, np.float64), np.asarray(T, np.float64)
            Qp = np.eye(m) - Vn @ Tn @ Vn.T
            err = np.max(np.abs(Qp.T @ P - np.asarray(Rf)))
            assert err < 1e-4, (m, w, err)


def test_blockqr_offset_sweep():
    """Sweep panel width vs n including widths that do not divide n."""
    rng = np.random.default_rng(1)
    A = rng.random((96, 60)).astype(np.float32)
    for r in (7, 13, 16, 30, 60, 64):
        Q, R = block_qr(A, block_size=r, mode="complete")
        rep = metrics.evaluate(A, Q, R, precision_bits=23)
        assert rep.all_ok, (r, str(rep))


@pytest.mark.parametrize(
    "in_dt,acc_dt,tol",
    [
        (jnp.float32, jnp.float32, 1e-6),
        (jnp.bfloat16, jnp.float32, 0.0),
        (jnp.float16, jnp.float32, 0.0),
        (jnp.bfloat16, jnp.bfloat16, 2.0 ** -7),
        (jnp.float16, jnp.float16, 2.0 ** -10),
    ],
)
def test_policy_matmul_dtype_combo_sweep(in_dt, acc_dt, tol):
    """Dtype-combo sweep of the policy GEMM (``ops/policy.py::matmul``, the
    precision boundary every trailing/Q update goes through) mirroring the
    reference's TensorCore template instantiations (fp16fp16fp32 / fp16^3):
    the result equals the float64 product of the CAST operands to within
    the accumulator's rounding."""
    from mixedprecisionblockqr_tpu.ops.policy import matmul

    rng = np.random.default_rng(2)
    a = rng.random((48, 32)).astype(np.float32)
    b = rng.random((32, 16)).astype(np.float32)
    c = matmul(jnp.asarray(a), jnp.asarray(b), in_dtype=in_dt,
               accum_dtype=acc_dt)
    assert c.dtype == jnp.dtype(acc_dt)
    ac = np.asarray(jnp.asarray(a).astype(in_dt), np.float64)
    bc = np.asarray(jnp.asarray(b).astype(in_dt), np.float64)
    ref = ac @ bc
    err = np.max(np.abs(np.asarray(c, np.float64) - ref)) / np.abs(ref).max()
    # fp32 accumulation of 16-bit operands: exact products, fp32 sums.
    assert err <= max(tol, 32 * 2.0 ** -24), err


def test_size_sweep_generator():
    assert list(size_sweep(64, 512)) == [64, 128, 256, 512]


def test_policy_sweep_error_ordering():
    """Across the dtype-policy sweep, error must be monotone:
    fp32 <= mixed (bf16 updates)."""
    A = np.random.default_rng(3).random((128, 96)).astype(np.float32)
    errs = {}
    for name, pol in (("fp32", POLICY_FP32), ("mixed", POLICY_MIXED)):
        Q, R = block_qr(A, block_size=32, policy=pol, mode="complete")
        errs[name] = float(metrics.backward_error(jnp.asarray(A), Q, R))
    assert errs["fp32"] < errs["mixed"]


@pytest.mark.parametrize("pm", ["bgs", "bgs1", "polar"])
@pytest.mark.parametrize("shape", [(256, 256), (512, 256), (384, 384)])
def test_fast_tier_shape_sweep(pm, shape):
    """Round-3 fast tiers (bgs/bgs1/polar + fused kernels) across shapes
    and both policies — criteria must hold everywhere the tier engages
    (it silently falls back to cholqr1/polar on unsupported shapes, which
    must also stay inside criteria)."""
    m, n = shape
    A = np.random.default_rng(m + n).standard_normal(shape).astype(np.float32)
    for pol, bits in ((POLICY_FP32, 23), (POLICY_MIXED, 8)):
        mode = "complete" if m == n else "reduced"
        Q, R = block_qr(A, block_size=128, policy=pol, mode=mode,
                        panel_method=pm)
        rep = metrics.evaluate(A, np.asarray(Q), np.asarray(R),
                               precision_bits=bits)
        assert rep.all_ok, f"{pm} {shape} {bits}b: {rep}"
