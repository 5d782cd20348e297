"""Precision study — dtype x condition-number error/duration tables.

Behavior parity with the reference's study (``python/performance_test.py``,
results in ``python/performance_test_result/{error,duration}.md``): sweep
Householder QR over sizes x condition numbers x dtypes, emit markdown
tables of backward error and duration.

Key reproduction + divergence: the reference's fp16 runs overflow to NaN at
cond >= 1e6 (``error.md:15-16``) because fp16 has a 5-bit exponent.  bf16
keeps fp32's 8-bit exponent, so the same matrices stay finite — the study
runs BOTH (fp16 on CPU via NumPy-backed emulation, bf16 on device) to
document that the bf16 dtype choice removes the reference's failure
mode while keeping the same mantissa-driven error scale.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

import numpy as np

from mixedprecisionblockqr_tpu.ops.blockqr import block_qr
from mixedprecisionblockqr_tpu.ops.policy import (
    DTypePolicy,
    POLICY_BF16,
    POLICY_FP32,
)
from mixedprecisionblockqr_tpu.utils.datagen import conditioned_matrix


def _error(A: np.ndarray, Q: np.ndarray, R: np.ndarray) -> float:
    A = A.astype(np.float64)
    return float(
        np.linalg.norm(A - Q.astype(np.float64) @ R.astype(np.float64))
        / np.linalg.norm(A)
    )


def _qr_numpy_fp16(A: np.ndarray):
    """fp16 Householder QR on CPU — the reference's NaN-prone configuration
    (its study runs NumPy fp16, ``performance_test.py``).  Kept tiny and
    unblocked: the point is the dtype behavior, not speed."""
    A = A.astype(np.float16)
    m, n = A.shape
    Q = np.eye(m, dtype=np.float16)
    R = A.copy()
    for k in range(min(m - 1, n)):
        x = R[k:, k].astype(np.float16)
        sigma = np.float16(np.linalg.norm(x.astype(np.float16)))
        if sigma == 0:
            continue
        u = x.copy()
        u[0] = np.float16(u[0] + np.sign(u[0] + np.float16(1e-8)) * sigma)
        norm_u = np.float16(np.linalg.norm(u.astype(np.float16)))
        if norm_u == 0:
            continue
        # No finiteness guard: the reference's fp16 path lets inf/NaN
        # propagate (performance_test_result/error.md:15-16) — reproducing
        # that failure mode is the point of this configuration.
        w = (u / norm_u).astype(np.float16)
        R[k:, :] = (R[k:, :] - 2 * np.outer(w, w @ R[k:, :])).astype(np.float16)
        Q[:, k:] = (Q[:, k:] - 2 * np.outer(Q[:, k:] @ w, w)).astype(np.float16)
    return Q, R


def run_study(
    sizes: Sequence[int] = (128, 256, 500),
    condition_numbers: Sequence[float] = (1e3, 1e4, 1e5, 1e6, 1e7),
    block_size: int = 64,
) -> Dict[str, List[dict]]:
    """Returns records: one per (size, cond, dtype) with error + duration."""
    records: List[dict] = []
    for n in sizes:
        for cond in condition_numbers:
            A = conditioned_matrix(n, cond, seed=0).astype(np.float64)
            cases = [
                ("fp16(cpu)", None),
                ("bf16", POLICY_BF16),
                ("fp32", POLICY_FP32),
            ]
            for name, policy in cases:
                t0 = time.perf_counter()
                if policy is None:
                    Qh, Rh = _qr_numpy_fp16(A)
                    Qn, Rn = Qh.astype(np.float64), np.triu(Rh.astype(np.float64))
                else:
                    Q, R = block_qr(
                        A.astype(np.float32),
                        block_size=min(block_size, n),
                        policy=policy,
                        mode="complete",
                    )
                    Qn, Rn = np.asarray(Q, np.float64), np.asarray(R, np.float64)
                dt = time.perf_counter() - t0
                err = _error(A, Qn, Rn)
                records.append(
                    {"n": n, "cond": cond, "dtype": name,
                     "error": err, "seconds": dt,
                     "finite": bool(np.isfinite(err))}
                )
            # LAPACK fp64 oracle row (reference's baseline column).
            t0 = time.perf_counter()
            Qn, Rn = np.linalg.qr(A)
            dt = time.perf_counter() - t0
            records.append(
                {"n": n, "cond": cond, "dtype": "lapack_fp64",
                 "error": _error(A, Qn, Rn), "seconds": dt, "finite": True}
            )
    return {"records": records}


def to_markdown(study: Dict[str, List[dict]]) -> Dict[str, str]:
    """Render {error.md, duration.md}-style tables (rows = size x cond,
    columns = dtypes), matching the reference's result layout."""
    records = study["records"]
    dtypes = []
    for r in records:
        if r["dtype"] not in dtypes:
            dtypes.append(r["dtype"])
    keys = []
    for r in records:
        k = (r["n"], r["cond"])
        if k not in keys:
            keys.append(k)

    def table(field: str, fmt) -> str:
        lines = ["| n | cond | " + " | ".join(dtypes) + " |",
                 "|---|---|" + "---|" * len(dtypes)]
        for n, cond in keys:
            row = [str(n), f"{cond:.0e}"]
            for d in dtypes:
                rec = next(
                    r for r in records
                    if r["n"] == n and r["cond"] == cond and r["dtype"] == d
                )
                row.append(fmt(rec[field]))
            lines.append("| " + " | ".join(row) + " |")
        return "\n".join(lines) + "\n"

    err_md = (
        "# Backward error ||A-QR||/||A|| by dtype\n\n"
        "fp16 reproduces the reference's NaN overflow at high condition\n"
        "numbers (performance_test_result/error.md:15-16); bf16 (same\n"
        "mantissa class, fp32 exponent) stays finite — the documented\n"
        "divergence of the bf16 dtype choice.\n\n"
        + table("error", lambda v: "NaN" if not np.isfinite(v) else f"{v:.2e}")
    )
    dur_md = "# Duration (seconds, includes compile on first config)\n\n" + table(
        "seconds", lambda v: f"{v:.3f}"
    )
    return {"error.md": err_md, "duration.md": dur_md}


def write_study(out_dir: str = "log/precision_study", **kw) -> List[str]:
    import os

    study = run_study(**kw)
    files = to_markdown(study)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, content in files.items():
        p = os.path.join(out_dir, name)
        with open(p, "w") as f:
            f.write(content)
        paths.append(p)
    return paths
