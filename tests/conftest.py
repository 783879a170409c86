"""Test config: a virtual 8-device CPU mesh for the sharding tests.

The tests run on the CPU (``JAX_PLATFORMS=cpu``). Multi-device sharding is
validated without real hardware via ``xla_force_host_platform_device_count``
(SURVEY.md §4 test plan), which must be set before JAX initializes, hence
here at import time. Tests marked ``gpu`` need a card: the ``gpu`` fixture
skips them anywhere else.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The GPU devices; skips the test where JAX finds none."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU (run: python chip_smoke.py on the card)")
    return devices
