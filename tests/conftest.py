"""Test configuration: run everything on a host-simulated 8-device CPU mesh.

Distributed tests (TSQR/CAQR/dist-QR sharding) need multiple devices, so all
tests force the CPU platform with 8 virtual devices — the reference's CPU
oracles play the same role for its CUDA kernels (SURVEY §4).  The GPU kernel
runs here in interpret mode; the program runs on the card through
``python chip_smoke.py`` (and ``--four`` on four cards).

This must run before jax is imported anywhere.
"""

import os

# CPU unless the caller names a platform: the card-only tests (marker
# ``gpu``) run on the card with JAX_PLATFORMS=cuda.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)  # fp64 oracle paths

# Persistent compilation cache: the suite compiles many static-shaped QR
# programs; cache them across runs (first run pays, reruns are fast).
from mixedprecisionblockqr_tpu.utils.cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# XLA:CPU JIT code-space guard.  With ~230 compiled programs live in one
# process, the NEXT compile (or persistent-cache load — both end in the
# same executable-loading step) SEGFAULTS deterministically in jaxlib
# (jax 0.9.0: backend_compile_and_load / get_executable_and_time /
# put_executable_and_time frames, always once the full suite reaches
# test #237; the same test passes in isolation or any smaller file
# combination).  Dropping the in-memory executable references early
# frees the code space; re-runs reload from the persistent cache.
_CLEAR_EVERY = 100
_test_counter = {"n": 0}


@pytest.fixture(autouse=True)
def _xla_code_space_guard():
    yield
    _test_counter["n"] += 1
    if _test_counter["n"] % _CLEAR_EVERY == 0:
        jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """For tests marked ``gpu``: skip unless JAX sees a GPU.  Decided here,
    at run time — never at import — so every xdist worker collects the
    same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run on the card with "
                    "`JAX_PLATFORMS=cuda python -m pytest tests -m gpu`")
