"""Test configuration.

The suite runs on the CPU. Sharding tests use an 8-device virtual CPU mesh
in place of several cards (XLA_FLAGS must be set before JAX starts its
backends). JAX_PLATFORMS, when set, picks the platform; otherwise it is
the CPU.

Tests that need a GPU carry the `gpu` marker and take the `gpu` fixture,
which skips them on any other platform. `chip_smoke.py` runs them in its
own process on the card (`python -m pytest -m gpu tests/` there works too).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from cornelis.utils.cache import enable_persistent_cache  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", False)
# The suite is dominated by compiles of small programs; cache them.
enable_persistent_cache()


@pytest.fixture
def gpu():
    """Skip unless JAX's default platform is a GPU (decided at test time,
    never at import, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this on the card")
