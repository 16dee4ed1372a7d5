"""Test config: run JAX on a virtual 8-device CPU mesh.

The standard fake-backend trick for testing pmap/pjit/shard_map sharding
without real multi-chip hardware (SURVEY.md §4). Must be set before jax
is imported anywhere in the test process.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# an accelerator plugin may be registered whatever the env var says; force
# the virtual 8-device CPU mesh explicitly (tests never need the card).
jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

from game_engine_tpu.gamespec.parser import load_builtin  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skips (through the `gpu` fixture) when "
        "JAX finds none. On the card these paths run through chip_smoke.py.")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU. Decided here, at run
    time, never at import or collection. No test takes it yet: it is
    reserved for a test of code that runs only on the card (a CUDA kernel
    has no interpret mode)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; run python chip_smoke.py on the card")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def werewolf_spec():
    return load_builtin("werewolf")


@pytest.fixture(scope="session")
def twotruths_spec():
    return load_builtin("two-truths-and-a-lie")
