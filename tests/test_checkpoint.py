"""Checkpoint/resume (SURVEY §5): the segmented scan-BGS driver must
survive interruption and resume to a result identical to an
uninterrupted run — the capability the reference never needed at its
single-GPU ~2000^2 scale but a multi-minute large or sharded run does."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import mixedprecisionblockqr_tpu as mpq
from mixedprecisionblockqr_tpu.models.resumable import (
    _latest_step,
    block_qr_resumable,
    clear_checkpoints,
)
from mixedprecisionblockqr_tpu.ops.blockqr import _block_qr_bgs_scan
from mixedprecisionblockqr_tpu.ops.policy import POLICY_FP32


def _problem(n=256, seed=0):
    return np.random.default_rng(seed).standard_normal((n, n)).astype(
        np.float32
    )


def test_resumable_matches_one_shot(tmp_path):
    a = _problem()
    ckpt = str(tmp_path / "ck")
    Q, R = block_qr_resumable(
        a, ckpt, block_size=32, policy=POLICY_FP32, group_panels=2,
        reorth=False, segment_groups=2,
    )
    R1, Q1, _ = jax.jit(
        lambda x: _block_qr_bgs_scan(
            x, 32, POLICY_FP32, True, None, reorth=False, group_panels=2
        )
    )(jnp.asarray(a))
    # Same step function, same order — any difference is XLA fusion noise
    # across the segment boundaries, bounded well under fp32 roundoff
    # accumulation at this size.
    np.testing.assert_allclose(np.asarray(Q), np.asarray(Q1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(R), np.asarray(R1),
                               rtol=1e-5, atol=1e-4)
    rep = mpq.metrics.evaluate(a, np.asarray(Q), np.asarray(R),
                               precision_bits=23)
    # Single-pass CGS (reorth=False, the grouped tier) sits marginally
    # above the tight 2^-23*m orthogonality line by design — the reorth
    # tier's criterion run is test_resumable_with_qtb_and_quality.
    assert rep.backward < rep.limit and rep.orthogonality < 1e-4, str(rep)


def test_interrupt_and_resume_is_identical(tmp_path):
    a = _problem(seed=1)
    ck_int = str(tmp_path / "interrupted")
    ck_one = str(tmp_path / "uninterrupted")

    # "Preempted" run: one segment per call, stopping after each.
    out = block_qr_resumable(
        a, ck_int, block_size=32, policy=POLICY_FP32, group_panels=2,
        reorth=False, segment_groups=1, max_segments=1,
    )
    assert out is None  # stopped early, checkpoint on disk
    assert _latest_step(ck_int) == 1
    while out is None:
        out = block_qr_resumable(
            a, ck_int, block_size=32, policy=POLICY_FP32, group_panels=2,
            reorth=False, segment_groups=1, max_segments=1,
        )
    Qi, Ri = out

    Qu, Ru = block_qr_resumable(
        a, ck_one, block_size=32, policy=POLICY_FP32, group_panels=2,
        reorth=False, segment_groups=1,
    )
    # Identical segment programs + checkpoint round-trip of exact arrays:
    # resumed == uninterrupted, bitwise.
    np.testing.assert_array_equal(np.asarray(Qi), np.asarray(Qu))
    np.testing.assert_array_equal(np.asarray(Ri), np.asarray(Ru))


def test_completed_run_restores_without_recompute(tmp_path):
    a = _problem(seed=2)
    ckpt = str(tmp_path / "ck")
    Q, R = block_qr_resumable(a, ckpt, block_size=32, policy=POLICY_FP32,
                              reorth=False, segment_groups=8)
    # A second call sees the final checkpoint and returns the same result
    # (no segments to execute).
    Q2, R2 = block_qr_resumable(a, ckpt, block_size=32, policy=POLICY_FP32,
                                reorth=False, segment_groups=8)
    np.testing.assert_array_equal(np.asarray(Q), np.asarray(Q2))
    np.testing.assert_array_equal(np.asarray(R), np.asarray(R2))
    clear_checkpoints(ckpt)
    assert _latest_step(ckpt) is None


def test_resumable_with_qtb_and_quality(tmp_path):
    a = _problem(seed=3)
    b = np.random.default_rng(4).standard_normal((256, 3)).astype(np.float32)
    ckpt = str(tmp_path / "ck")
    Q, R, qtb = block_qr_resumable(a, ckpt, block_size=32,
                                   policy=POLICY_FP32, B=jnp.asarray(b),
                                   reorth=True, segment_groups=3)
    rep = mpq.metrics.evaluate(a, np.asarray(Q), np.asarray(R),
                               precision_bits=23)
    assert rep.all_ok and rep.tight_ok, str(rep)
    # Q^T B must actually come back (it was threaded through every
    # segment AND checkpointed — review finding: it used to be dropped
    # at finalize) and match the explicit product.
    np.testing.assert_allclose(
        np.asarray(qtb), np.asarray(Q).T @ b, rtol=1e-4, atol=1e-4
    )


def test_resumable_tall_returns_reduced_r(tmp_path):
    """Review finding: tall inputs returned the zero-padded (m, n) R_full,
    breaking the documented block_qr-reduced contract (Q @ R crashed)."""
    a = np.random.default_rng(6).standard_normal((128, 64)).astype(
        np.float32
    )
    Q, R = block_qr_resumable(a, str(tmp_path / "ck"), block_size=32,
                              reorth=True, segment_groups=8)
    assert Q.shape == (128, 64) and R.shape == (64, 64)
    rep = mpq.metrics.evaluate(a, np.asarray(Q), np.asarray(R),
                               precision_bits=23)
    assert rep.all_ok, str(rep)


def test_complete_mode_contract():
    a = np.random.default_rng(5).standard_normal((64, 32)).astype(np.float32)
    with pytest.raises(ValueError):
        block_qr_resumable(a, "/tmp/unused-ck", mode="complete")
    # Shape validation (review finding): indivisible n used to die on the
    # scan machinery's internal assert with no message.
    bad = np.random.default_rng(7).standard_normal((256, 200)).astype(
        np.float32
    )
    with pytest.raises(ValueError, match="block_size"):
        block_qr_resumable(bad, "/tmp/unused-ck")
