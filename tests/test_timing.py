"""Timing/profiling utilities."""

import jax.numpy as jnp
import numpy as np
import pytest

from mixedprecisionblockqr_tpu.utils.timing import (
    device_peak_tflops,
    time_fn,
    time_step_amortized,
    trace,
)


def test_time_fn_returns_result():
    sec, out = time_fn(lambda x: x * 2, jnp.ones(8), warmup=1, iters=2)
    assert sec >= 0
    np.testing.assert_array_equal(np.asarray(out), 2 * np.ones(8))


def test_time_step_amortized_positive():
    x0 = jnp.ones((64, 64))
    sec = time_step_amortized(lambda x: x * 1.0000001, x0, iters=4, repeats=2)
    assert sec > 0


def test_trace_scope_noop():
    with trace("scope"):
        pass


def test_device_peak_lookup():
    # The CPU test backend has no data-sheet row: an error, not a default.
    with pytest.raises(KeyError, match="no peak rates"):
        device_peak_tflops()


@pytest.mark.parametrize("dtype,rate", [
    ("bfloat16", 989.0), ("float16", 989.0), ("tf32", 495.0),
    ("float32", 67.0),
])
def test_device_peak_h100_rates(dtype, rate):
    assert device_peak_tflops(dtype, kind="NVIDIA H100 80GB HBM3") == rate


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB"])
def test_device_peak_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match=kind):
        device_peak_tflops("bfloat16", kind=kind)
