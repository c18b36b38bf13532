"""Test harness config: force an 8-virtual-device CPU mesh.

NOTE: jax may already be imported at interpreter startup (platform plugin
.pth hook), so setting JAX_PLATFORMS via os.environ is too late — we use
jax.config.update before the first backend initialization instead.
"""
import os

# XLA_FLAGS is read at first backend init, which has not happened yet.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# NOTE: do NOT point jax's persistent compilation cache at the suite
# (jax_compilation_cache_dir + zeroed entry floors): on jax 0.4.37 XLA:CPU
# executable deserialization segfaults on the shard_map/donated TrainStep
# executables (reproduced in tests/test_elastic_reshard.py) — a warm second
# run crashes the interpreter. Cold compiles are slow on small-core runners
# but correct.

import gc  # noqa: E402

import pytest  # noqa: E402

# Every compiled executable pins ~6 mmap'd regions for the life of the
# process. A full single-process tier-1 run accumulates past the kernel's
# vm.max_map_count (65530 default) and XLA's next allocation SEGFAULTS the
# interpreter (reproduced deterministically around tests/test_utils_longtail
# at ~64k regions). Between modules, when the region count nears the limit,
# drop every compiled-executable cache and collect. Only ever fires near the
# ceiling, so cross-module compile reuse is kept until it has to go; clearing
# at a module BOUNDARY cannot perturb in-module trace/retrace-count gates.
_MAP_GUARD_THRESHOLD = 35_000


def _mapped_regions():
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:  # non-Linux: no /proc, and no 65530 ceiling either
        return 0


@pytest.fixture(autouse=True, scope="module")
def _vm_map_guard():
    if _mapped_regions() > _MAP_GUARD_THRESHOLD:
        jax.clear_caches()
        gc.collect()
    yield


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running benches excluded from the tier-1 '-m not slow' "
        "gate")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (a hand-written kernel without a CPU "
        "mode); skips where torch.cuda.is_available() is False")


@pytest.fixture(scope="session")
def devices8():
    devs = jax.devices()
    assert len(devs) == 8, f"expected 8 virtual cpu devices, got {len(devs)}"
    return devs
