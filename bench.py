"""Headline benchmark: 2048x2048 mixed-precision blocked QR on one GPU (the
BASELINE.json north-star config: fp32 panel + bf16 tensor-core GEMMs with
fp32 accumulation).

Prints the card's ``nvidia-smi`` name and power limit, then ONE JSON line:
    {"metric": ..., "value": N, "unit": "TFLOP/s", "vs_baseline": N, ...}

``vs_baseline`` is measured TFLOP/s divided by the north-star target of 50%
of the card's dense bf16 peak (``utils/timing.py::PEAKS``; an unknown card
is an error); >= 1.0 means the target is met.  FLOPs use the reference's own
analytic QR model (``h_qr_flops_per_second``, ``Cuda/qr.cu:102-113``).
Error metrics are asserted against the reference's acceptance criteria
before timing counts.

The timed program is the PUBLIC ``block_qr`` path end-to-end —
``panel_method='auto'`` dispatch + ``check='defer'`` (no host sync, so the
whole public call traces into the in-jit timing loop).

Run: ``python bench.py`` (one card).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from mixedprecisionblockqr_tpu.ops import metrics
from mixedprecisionblockqr_tpu.ops.policy import POLICY_MIXED_FAST
from mixedprecisionblockqr_tpu.utils.cache import enable_compile_cache
from mixedprecisionblockqr_tpu.utils.flops import qr_flops
from mixedprecisionblockqr_tpu.utils.timing import (
    card_line,
    device_peak_tflops,
    time_step_amortized,
)

M = N = 2048
BLOCK = 128
# The auto dispatch (ops/blockqr.py::resolve_panel_config) resolves this
# config on a GPU to Block Gram-Schmidt 'bgs1', group_panels=8.
# POLICY_MIXED_FAST: bf16-resident Q output.
POLICY = POLICY_MIXED_FAST


def main() -> int:
    enable_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    peak = device_peak_tflops("bfloat16")  # raises on an unknown card
    card = card_line()
    print(card)

    a = np.random.default_rng(0).random((M, N), dtype=np.float32) - 0.5
    A = jnp.asarray(a)

    from mixedprecisionblockqr_tpu.ops.blockqr import block_qr

    # The public driver, jitted end-to-end: auto dispatch happens at trace
    # time, check='defer' adds no host synchronization (the NaN canary
    # rides in R[0,0] and is asserted by the quality gate below).
    # quality='fast' is pinned EXPLICITLY: block_qr's auto default is the
    # throughput rung anyway, but the headline must state its ladder rung
    # rather than inherit it (the convenience entry qr() defaults mixed
    # policies to 'balanced').
    public = jax.jit(
        lambda x: block_qr(
            x, BLOCK, POLICY, mode="complete", panel_method="auto",
            quality="fast", check="defer",
        )
    )

    # Quality gate first (the EXACT program the timing loop runs).
    Q, R_full = public(A)
    rep = metrics.evaluate(a, np.asarray(Q), np.asarray(R_full),
                           precision_bits=POLICY.precision_bits)

    # Amortized device timing (utils/timing.py).
    def step(x):
        Qc, R_full = public(x)
        return x * (1.0 + 1e-12 * R_full[0, 0].astype(jnp.float32))

    seconds = time_step_amortized(step, A, iters=96)
    tflops = qr_flops(M, N) / seconds / 1e12
    target = 0.5 * peak
    if tflops > 0.75 * peak:
        # No QR driver reaches 75% of raw matmul peak — an implausibly
        # high reading means the measurement was noise-corrupted;
        # re-measure with a longer chain and keep the conservative value.
        seconds2 = time_step_amortized(step, A, iters=192)
        seconds = max(seconds, seconds2)
        tflops = qr_flops(M, N) / seconds / 1e12

    result = {
        "metric": f"{M}x{N} mixed-precision block QR "
                  "(fp32 panel + bf16 tensor-core GEMMs)",
        "value": round(tflops, 3),
        "unit": "TFLOP/s",
        "vs_baseline": round(tflops / target, 4),
        "seconds": round(seconds, 5),
        "backward_error": rep.backward,
        "orthogonality_error": rep.orthogonality,
        "criteria_ok": rep.all_ok,
        # Secondary regression gate 2^-bits*sqrt(m) (ops/metrics.py::
        # tight_limit) — the reference's 2^-bits*m acceptance bound alone
        # cannot fail at this m; this one can.
        "tight_ok": rep.tight_ok,
        "device": jax.devices()[0].device_kind,
        "card": card,
        "block_size": BLOCK,
        "target_tflops_50pct_peak": target,
        "timed_path": "public block_qr(panel_method='auto', check='defer')",
    }
    print(json.dumps(result))
    return 0 if (rep.all_ok and rep.tight_ok) else 1


if __name__ == "__main__":
    sys.exit(main())
