"""Test harness: run JAX on a virtual 8-device CPU mesh so multi-device
sharding is exercised without accelerator hardware (SURVEY.md §4).

Tests that need the GPU are marked @pytest.mark.gpu and take the `gpu`
fixture, which skips them when no card is present. On a machine with the
card they run with VIDEOQUERY_TESTS_ON_CARD=1 (then the platform is left
to JAX instead of forced to the CPU):

    VIDEOQUERY_TESTS_ON_CARD=1 python -m pytest tests/ -m gpu
"""

import os

ON_CARD = os.environ.get("VIDEOQUERY_TESTS_ON_CARD") == "1"

# Force CPU: unit tests run on the virtual 8-device CPU mesh. jax snapshots
# JAX_PLATFORMS into its config when it is imported, and a pytest plugin may
# import jax BEFORE this conftest — so the env var alone is not enough;
# update the live config too (the backend itself is not yet initialized at
# plugin-import time, so XLA_FLAGS still applies).
if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu", (
        "tests must run on the virtual CPU mesh, got "
        + jax.devices()[0].platform)
    assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"
os.environ.setdefault("COMPUTE_EPS", "1e-6")
os.environ.setdefault("RANDOM_SEED", "None")

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest


# Ground-truth embedding fixtures: vendored copy of the reference's C17
# sample data (tests/data/README.md). The env mount is only a fallback so
# the fixtures can be re-diffed against the original.
_VENDORED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "data", "features")
REFERENCE_FIXTURES = (_VENDORED if os.path.isdir(_VENDORED)
                      else "/root/reference/data/features")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when there is none. Decided
    here, at run time, never while a module is imported, so every pytest
    worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (found {dev.platform}); chip_smoke.py runs "
                    "the same comparisons on the card")
    return dev


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU")
    config.addinivalue_line("markers", "slow: long-running test")
