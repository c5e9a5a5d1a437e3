"""Test harness: force CPU with a virtual 8-device mesh.

The standard JAX trick (SURVEY §4.5): sharding / shard_map / psum logic is
exercised on one machine with `--xla_force_host_platform_device_count=8`.
The CPU is selected through jax.config before any backend is initialized.
Set TINYSLAM_TEST_DEVICE=1 to run on JAX's default backend instead; tests
marked `gpu` need it (they compile kernels for the card and skip elsewhere):

    TINYSLAM_TEST_DEVICE=1 python -m pytest tests/ -m gpu
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

if os.environ.get("TINYSLAM_TEST_DEVICE", "0") != "1":
    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_backend():
    """Skip unless JAX's default backend is a GPU (decided at run time, not
    at import, so every pytest-xdist worker collects the same tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU (run with TINYSLAM_TEST_DEVICE=1 -m gpu)")
