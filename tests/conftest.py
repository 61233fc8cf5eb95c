"""Test harness configuration.

Tests run on the CPU with 8 virtual devices, so the multi-device
sharding paths compile and execute without an accelerator.  Must be
set before jax is imported.
"""
import os
import sys
from pathlib import Path

# The environment variable alone does not win over a platform that a
# site configuration pinned before conftest ran: also set it through
# jax.config before any backend is initialized.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

import pytest  # noqa: E402

REFERENCE = Path("/root/reference")
TESTDATA = REFERENCE / "testdata"
GOLDEN = REFERENCE / "golden"

CLIP = "A_Tusk_is_used_to_make_costly_gifts"


@pytest.fixture(scope="session")
def testdata():
    if not TESTDATA.is_dir():
        pytest.skip("reference testdata not available")
    return TESTDATA


@pytest.fixture(scope="session")
def golden():
    if not GOLDEN.is_dir():
        pytest.skip("reference golden corpus not available")
    return GOLDEN


# Fast-subset marking: the heaviest modules (batched device paths that
# jit-compile large programs on the virtual-CPU mesh) carry the `slow`
# marker so the developer loop can run `pytest -m "not slow"` (~1 min)
# while CI still runs everything.
_SLOW_MODULES = {
    "test_aac_lc",
    "test_batched_models",
    "test_fleet",
    "test_flac_device",
    "test_mp3_native",
    "test_resample",
    "test_stretch",
    "test_mesh_coverage",
}


def pytest_collection_modifyitems(config, items):
    import pytest

    for item in items:
        if item.module.__name__ in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
