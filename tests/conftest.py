"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device sharding logic is validated on CPU via virtual devices
(SURVEY.md section 4); the GPU path is exercised by ``chip_smoke.py``.
The device count must be configured before any backend initialization.
"""

import pathlib

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)


# Slow tier: the multi-device engine tests drive full sample() programs over
# meshes of virtual devices.  Tests in these modules (plus anything
# individually marked) carry @pytest.mark.slow, so `pytest -m "not slow"`
# gives the fast tier.
_SLOW_MODULES = {"test_multichip"}


def pytest_collection_modifyitems(items):
    for item in items:
        if pathlib.Path(str(item.fspath)).stem in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
