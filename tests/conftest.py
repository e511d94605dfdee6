"""Test config: pin JAX to the CPU with an 8-device virtual mesh so sharding
tests run anywhere (``__graft_entry__.dryrun_multichip`` rehearses the same
mesh paths), and keep the suite out of the persistent compile cache.  The
environment variables reach the subprocesses tests spawn (CLI byte-parity
runs, Perl wrappers, the multi-process distributed test) as well.

Tests marked ``gpu`` need a CUDA device; the ``gpu_device`` fixture skips
them elsewhere.  On a machine with a card:
``python -m pytest tests/ -m gpu -p no:cacheprovider``.
"""

import os

if os.environ.get("SEQALIGN_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_COMPILATION_CACHE"] = "false"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (run with SEQALIGN_TEST_GPU=1)")


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test when there is none.  Decided
    here, at run time, so every xdist worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA device (SEQALIGN_TEST_GPU=1 on a GPU "
                    "machine)")
    return jax.devices()[0]


# The XLA CPU backend's LLVM JIT occasionally segfaults/aborts inside
# backend_compile after many jit compilations in one process (always in a
# LATER compile — typically the big 8-shard shard_map graphs of
# test_parallel; not OOM, and not stack exhaustion).  Dropping the
# executable caches bounds the JIT arena and eliminates the crash.  Clear
# at every module boundary (order-independent; recompile cost is a few
# seconds over the whole suite), plus a counter as a backstop within huge
# modules.
_TESTS_BETWEEN_CACHE_CLEARS = 200
_test_counter = {"n": 0}


def pytest_runtest_teardown(item, nextitem):
    _test_counter["n"] += 1
    if nextitem is not None and \
            item.module is not getattr(nextitem, "module", None):
        _test_counter["n"] = 0
        jax.clear_caches()
    elif _test_counter["n"] % _TESTS_BETWEEN_CACHE_CLEARS == 0:
        jax.clear_caches()
