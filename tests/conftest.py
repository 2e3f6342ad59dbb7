"""Test configuration: run the suite on a virtual 8-device CPU mesh with
float64 enabled, standing in for a multi-device host (SURVEY.md §4
carry-over: multi-device tests via xla_force_host_platform_device_count)."""

import os

# must be set before the first jax backend initialization
os.environ.setdefault("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import pytest  # noqa: E402

from triflow_jax.utils.compile_cache import enable_compile_cache  # noqa: E402

# the CPU unless JAX_PLATFORMS names others (the gpu-marked tests run on
# the card with JAX_PLATFORMS=cuda,cpu)
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the suite is compile-bound on CPU, so cache
# XLA executables across runs (first run pays, reruns are fast).
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test when JAX finds none."""
    try:
        return jax.devices("cuda")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU: JAX finds no CUDA device")
