"""Test configuration: run everything on a virtual 8-device CPU mesh so the
multi-device sharding paths are exercised without a GPU.  No test opens a
GPU; the GPU path is `python chip_smoke.py` (README)."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Force the CPU backend even where JAX would pick a GPU by default: test
# workers must never open the card.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


# Marker taxonomy (README "Running the tests"):
#   -m smoke        core-correctness subset, < 5 min on this box
#   -m "not slow"   everything except the statistical recompute campaigns
SMOKE_MODULES = {
    "test_numth", "test_u32_ops", "test_oracle", "test_ntt_mxu",
    "test_protect", "test_protected", "test_serialize", "test_bigint",
}


def pytest_configure(config):
    config.addinivalue_line("markers", "smoke: fast core-correctness subset")
    config.addinivalue_line(
        "markers", "slow: statistical recompute campaigns (minutes)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__ in SMOKE_MODULES:
            item.add_marker(pytest.mark.smoke)
