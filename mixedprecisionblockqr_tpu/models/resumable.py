"""Checkpoint/resume for long-running factorizations (SURVEY §5).

The reference has no checkpointing at all — its closest artifact is the
append-only CSV log that survives across runs (``Cuda/qr.cu:58-83``; our
``cli.py suite --resume`` already mirrors that for sweeps).  This module
adds the large-scale piece the reference never needed: a SEGMENTED scan-BGS
driver whose carry (Qbuf, R, QtB, panel cursor, poison residual) is
orbax-checkpointed between device calls, so a multi-minute 16384^2-class
factorization — or a multi-hour virtual-mesh certification run — survives
preemption and resumes from the last completed segment.

Design: ``ops/blockqr.py::_bgs_scan_machinery`` exposes the scan driver's
step function, and the one-shot driver runs ``fori_loop(0, nsteps)`` over
it.  Here the same step runs as ``fori_loop(k0, k0+seg)`` inside one
jitted segment program (k0 is a traced scalar, so every segment reuses
ONE compiled program), with an orbax save after each segment.  Because
the step sequence is identical, a resumed factorization is numerically
IDENTICAL to an uninterrupted one — tested to equality in
``tests/test_checkpoint.py``.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mixedprecisionblockqr_tpu.ops.blockqr import (
    DEFAULT_BLOCK_SIZE,
    _bgs_scan_finalize,
    _bgs_scan_machinery,
)
from mixedprecisionblockqr_tpu.ops.policy import POLICY_FP32, DTypePolicy


@lru_cache(maxsize=None)
def _segment_fn(block_size, policy, platform, reorth, group_panels, with_b):
    """ONE compiled segment program per configuration: A (and B) are jit
    ARGUMENTS, not closure constants — a resume-after-preemption call in a
    fresh process hits the persistent XLA cache instead of re-tracing with
    the full matrix baked into the jaxpr (at 16384^2 that is a 1 GB
    constant and a recompile per resume, defeating the module's whole
    purpose)."""

    @jax.jit
    def seg(A, B, carry, k0, k1):
        step, _, _ = _bgs_scan_machinery(
            A, B if with_b else None, block_size, policy, platform=platform,
            reorth=reorth, group_panels=group_panels,
        )
        return jax.lax.fori_loop(k0, k1, step, carry)

    return seg

_CARRY_KEYS = ("qbuf", "r", "qtb", "worst_resid")


def _latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(name[5:]) for name in os.listdir(directory)
        if name.startswith("step_") and name[5:].isdigit()
        # orbax writes atomically (tmp dir + rename), but guard against a
        # crash BETWEEN checkpointers: require the marker it writes last.
        and os.path.isdir(os.path.join(directory, name))
    ]
    return max(steps) if steps else None


def _save(directory: str, k: int, carry) -> None:
    import orbax.checkpoint as ocp

    tree = dict(zip(_CARRY_KEYS, carry))
    path = os.path.join(os.path.abspath(directory), f"step_{k}")
    ocp.PyTreeCheckpointer().save(path, tree, force=True)


def _restore(directory: str, k: int, carry_like):
    import orbax.checkpoint as ocp

    abstract = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), carry_like
    )
    tree = ocp.PyTreeCheckpointer().restore(
        os.path.join(os.path.abspath(directory), f"step_{k}"),
        item=dict(zip(_CARRY_KEYS, abstract)),
    )
    return tuple(tree[key] for key in _CARRY_KEYS)


def block_qr_resumable(
    A,
    checkpoint_dir: str,
    block_size: int = DEFAULT_BLOCK_SIZE,
    policy: DTypePolicy = POLICY_FP32,
    mode: str = "reduced",
    B=None,
    group_panels: int = 1,
    reorth: bool = True,
    segment_groups: int = 4,
    max_segments: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Scan-BGS QR with orbax checkpoint/resume between segments.

    Runs ``segment_groups`` scan steps (each factoring ``group_panels``
    panels) per device call, saving the carry under
    ``checkpoint_dir/step_<k>`` after each.  Re-invoking with the same
    ``checkpoint_dir`` resumes from the newest complete checkpoint; the
    result is numerically identical to the uninterrupted driver (same
    step function — see module docstring).  On completion the checkpoint
    directory holds only the final marker ``step_<nsteps>`` (intermediate
    saves are pruned).

    ``max_segments`` bounds how many segments THIS call executes (for
    tests and cooperative schedulers); when the bound stops the run early
    the return is ``None`` — call again to continue.

    Returns ``(Q, R)`` like ``block_qr`` — reduced ``(m, n)/(n, n)``
    factors, or complete for m == n — plus ``Q^T B`` as a third element
    when ``B`` is given.  Returns ``None`` when stopped early by
    ``max_segments``.
    """
    A = jnp.asarray(A)
    m, n = A.shape
    if mode == "complete" and m != n:
        raise ValueError(
            "resumable driver: complete mode only for m == n "
            "(same contract as the BGS drivers)"
        )
    r = min(block_size, n)
    if n % r != 0 or m < n:
        # The scan machinery requires r | n and m >= n; surface a real
        # error instead of its internal assert (block_qr falls back to
        # the reflector tier on such shapes — this driver cannot, its
        # checkpointable carry IS the scan carry).
        raise ValueError(
            f"block_qr_resumable needs block_size | n and m >= n, got "
            f"shape {(m, n)} with block_size {r}; pad n to a multiple or "
            "use block_qr (whose hostile-shape fallback is not "
            "checkpointable)"
        )
    platform = jax.default_backend()
    _, carry0, nsteps = _bgs_scan_machinery(
        A, B, block_size, policy, platform=platform, reorth=reorth,
        group_panels=group_panels,
    )
    segment = _segment_fn(block_size, policy, platform, reorth,
                          group_panels, B is not None)
    Bc = (jnp.asarray(B) if B is not None
          else jnp.zeros((m, 1), jnp.float32))

    k = _latest_step(checkpoint_dir)
    if k is None:
        k, carry = 0, carry0
    elif k < nsteps:
        carry = _restore(checkpoint_dir, k, carry0)
    else:
        carry = _restore(checkpoint_dir, nsteps, carry0)

    done_segments = 0
    while k < nsteps:
        if max_segments is not None and done_segments >= max_segments:
            return None
        k1 = min(k + segment_groups, nsteps)
        # jnp.asarray keeps the index dtype canonical (int64 under the
        # x64 test config, int32 otherwise) so the step's dynamic slices see
        # one index type; the traced bounds mean ONE compiled segment
        # program serves every (k0, k1).
        carry = segment(A, Bc, carry, jnp.asarray(k), jnp.asarray(k1))
        carry = jax.block_until_ready(carry)
        _save(checkpoint_dir, k1, carry)
        prev = os.path.join(checkpoint_dir, f"step_{k}")
        if k > 0 and os.path.isdir(prev):
            import shutil

            shutil.rmtree(prev, ignore_errors=True)
        k = k1
        done_segments += 1

    Qbuf, R, QtB, worst_resid = carry
    R_full, Q, QtBout = _bgs_scan_finalize(
        m, n, policy, True, B is not None, Qbuf, R, QtB, worst_resid,
        reorth=reorth,
    )
    Rout = R_full if mode == "complete" else R_full[:n, :]
    if B is not None:
        return Q, Rout, QtBout
    return Q, Rout


def clear_checkpoints(checkpoint_dir: str) -> None:
    """Remove a factorization's checkpoint directory (post-completion
    housekeeping; safe on missing paths)."""
    import shutil

    shutil.rmtree(checkpoint_dir, ignore_errors=True)
