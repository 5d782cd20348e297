"""Benchmark timing harness.

The reference times with ``std::chrono`` around synchronous CUDA calls
(``Cuda/qr.cu:1354-1361``).  JAX dispatch is async: correct timing
requires ``block_until_ready`` after warmup (compile excluded), which this
harness standardizes.  ``jax.profiler`` trace capture replaces NVTX ranges
(``nvtxRangePush`` at ``Cuda/qr.cu:207,292,339``).
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Callable, Optional, Tuple

import jax


def _block(x):
    return jax.block_until_ready(x)


def time_fn(
    fn: Callable,
    *args,
    warmup: int = 2,
    iters: int = 5,
    **kwargs,
) -> Tuple[float, object]:
    """Median wall-clock seconds per call (post-warmup) and the last result.

    Per-call timing includes dispatch/transfer latency."""
    result = None
    for _ in range(max(warmup, 1)):
        result = _block(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        result = _block(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], result


def time_step_amortized(
    step_fn: Callable,
    x0,
    iters: int = 16,
    repeats: int = 3,
) -> float:
    """Device-compute seconds per application of ``step_fn`` (x -> x, same
    shape/dtype), measured as a difference of chained in-jit loops.

    Motivation: where every host fetch pays a large fixed latency,
    per-call wall timing measures that latency, not the device.  Here the
    step is iterated inside one jit via ``fori_loop`` with a
    runtime trip count (one compile), a single scalar is fetched, and the
    per-step time is (t[1+iters] - t[1]) / iters — fixed overhead cancels.
    """
    import jax.numpy as jnp

    @jax.jit
    def loop(x, n):
        def body(i, x):
            return step_fn(x)

        y = jax.lax.fori_loop(0, n, body, x)
        first = jnp.ravel(y)[0] if not isinstance(y, (tuple, list)) else jnp.ravel(y[0])[0]
        return first.astype(jnp.float32)

    float(loop(x0, 1))  # compile + warm
    t_base, t_long = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        float(loop(x0, 1))
        t_base.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        float(loop(x0, 1 + iters))
        t_long.append(time.perf_counter() - t0)
    return max(min(t_long) - min(t_base), 1e-9) / iters


@contextlib.contextmanager
def trace(name: str, log_dir: Optional[str] = None):
    """Named profiler scope; if ``log_dir`` is set, captures a full
    ``jax.profiler`` trace (Perfetto-compatible) around the block."""
    if log_dir is not None:
        jax.profiler.start_trace(log_dir)
    try:
        with jax.named_scope(name):
            yield
    finally:
        if log_dir is not None:
            jax.profiler.stop_trace()


#: Dense peak rates by ``jax.Device.device_kind``: TFLOP/s per dtype and
#: device-memory bandwidth in TB/s.  Source: NVIDIA H100 Tensor Core GPU
#: data sheet, SXM5 part at its 700 W power limit, without sparsity.  A
#: card set to a lower power limit cannot hold these clocks under a
#: matrix-heavy load, so every rate derived from them is reported beside
#: the card's ``nvidia-smi`` power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bfloat16": 989.0,
        "float16": 989.0,
        "tf32": 495.0,
        "float32": 67.0,
        "hbm_tb_s": 3.35,
    },
}


def device_peak_tflops(dtype: str = "bfloat16",
                       kind: Optional[str] = None) -> float:
    """Peak dense TFLOP/s of ``dtype`` ('bfloat16', 'float16', 'tf32',
    'float32') on ``kind`` (default: the first JAX device's
    ``device_kind``).  A device without a ``PEAKS`` row is an error, not a
    default: a rate divided by another card's peak means nothing."""
    if kind is None:
        kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(
            f"no peak rates recorded for device kind {kind!r}; add its "
            "data-sheet row to utils/timing.py::PEAKS"
        )
    return PEAKS[kind][dtype]


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name,power.limit``), read by a child process that stays off JAX.
    Every device number is reported beside it: a card set below its
    maximum power limit runs slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
