"""The platform decision: one dispatch table keyed on the platform name, the
shape and the policy (``ops/blockqr.py::resolve_panel_config``), and the
compile-cache location rule shared by every entry point."""

import os

import pytest

from mixedprecisionblockqr_tpu.ops.blockqr import resolve_panel_config
from mixedprecisionblockqr_tpu.ops.policy import (
    POLICY_FP32,
    POLICY_FP64,
    POLICY_MIXED,
    POLICY_MIXED_FAST,
)
from mixedprecisionblockqr_tpu.utils import cache

# (m, n, block, policy, quality, mode) -> the GPU resolution
# (panel_method, loop_mode, group_panels); group_panels passed in is 4.
_GPU_TABLE = [
    ((2048, 2048, 128, POLICY_MIXED_FAST, "fast", "complete"),
     ("bgs1", "unroll", 8)),
    ((2048, 2048, 128, POLICY_MIXED, "balanced", "reduced"),
     ("bgs2", "unroll", 8)),
    ((2048, 2048, 128, POLICY_MIXED, "high", "reduced"),
     ("bgs", "unroll", 8)),
    ((1024, 1024, 64, POLICY_FP32, None, "reduced"),
     ("bgs", "unroll", 4)),
    ((16384, 16384, 128, POLICY_MIXED, "balanced", "r"),
     ("bgs2", "scan", 4)),
    ((16384, 16384, 128, POLICY_MIXED_FAST, None, "reduced"),
     ("bgs1", "scan", 4)),
    ((16384, 16384, 128, POLICY_FP32, None, "reduced"),
     ("bgs", "scan", 4)),
    # The SLAM-shaped solve: r does not divide n -> the reflector tier.
    ((2000, 1000, 128, POLICY_FP32, None, "qtb"),
     ("householder", "unroll", 4)),
    ((2048, 2048, 128, POLICY_MIXED, "robust", "reduced"),
     ("householder", "unroll", 4)),
    ((2048, 2048, 128, POLICY_FP64, None, "reduced"),
     ("householder", "unroll", 4)),
    # complete-Q of a tall matrix cannot take the concatenation-Q BGS
    # driver: the fallback chain lands on the grouped reflector tier.
    ((4096, 1024, 128, POLICY_MIXED_FAST, None, "complete"),
     ("polar", "unroll", 8)),
]


@pytest.mark.parametrize("args,want", _GPU_TABLE)
def test_dispatch_gpu(args, want):
    m, n, r, policy, quality, mode = args
    got = resolve_panel_config(m, n, r, policy, "auto", "unroll", 4,
                               mode=mode, platform="gpu", quality=quality)
    assert got == want


@pytest.mark.parametrize("args,_", _GPU_TABLE)
def test_dispatch_cpu_is_reference_tier(args, _):
    """Every platform but the GPU takes the plain-XLA reference tier."""
    m, n, r, policy, quality, mode = args
    got = resolve_panel_config(m, n, r, policy, "auto", "unroll", 4,
                               mode=mode, platform="cpu", quality=quality)
    assert got == ("householder", "unroll", 4)


def test_dispatch_defaults_to_current_backend():
    # The test suite runs on the CPU backend.
    assert resolve_panel_config(
        2048, 2048, 128, POLICY_MIXED_FAST, "auto", "unroll", 4
    )[0] == "householder"


def test_cache_dir_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path / "elsewhere"))
    assert cache.cache_dir("/some/checkout") == str(tmp_path / "elsewhere")


def test_cache_dir_default_inside_checkout(monkeypatch, tmp_path):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    assert cache.cache_dir(str(tmp_path)) == os.path.join(
        str(tmp_path), ".jax_cache")
