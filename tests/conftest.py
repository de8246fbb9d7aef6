"""Test configuration: the tests run on the CPU, with a virtual 8-device
CPU platform so sharding tests run without several GPUs (the same trick
__graft_entry__.dryrun_multichip uses).  Tests that need the GPU carry the
``gpu`` marker and skip here through the ``gpu_device`` fixture."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX has none (decided when the test
    runs, never at import)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run on the card through "
                    "chip_smoke.py or pytest -m gpu")
    return devs[0]


@pytest.fixture(scope="session")
def cpu_devices():
    devs = jax.devices()
    assert devs[0].platform == "cpu" and len(devs) >= 8
    return devs
