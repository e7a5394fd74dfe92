import os

# Force the CPU backend with a virtual 8-device mesh for sharding tests,
# and x64 for the exact-precision model path.  Must run before jax inits.
# The platform is forced through both the environment and the config,
# so the suite stays on the CPU whatever the host's accelerators.
# Tests that need a GPU carry the ``gpu`` marker and skip without one;
# SNIPER_TEST_PLATFORM=cuda,cpu runs them (chip_smoke.py does).
_platform = os.environ.get("SNIPER_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _platform
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", _platform)
jax.config.update("jax_enable_x64", True)

from pathlib import Path  # noqa: E402

import pytest  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture(scope="session")
def data_dir() -> Path:
    return DATA
