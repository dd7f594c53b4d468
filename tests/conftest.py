"""Test configuration: run JAX on a virtual multi-device CPU mesh in float64.

Regression tests compare against the reference's testref/ behavior, which is
float64 CPU arithmetic; distributed tests use 8 virtual CPU devices
(xla_force_host_platform_device_count) to exercise jax.sharding without
accelerator hardware.

EXSADDLE_TEST_GPU=1 keeps the GPU visible instead: the opt-in for the tests
marked `gpu`, run in one process on a machine with a card:

    EXSADDLE_TEST_GPU=1 python -m pytest tests/ -m gpu -p no:xdist -q

(the rest of the suite is not expected to digit-match references on GPU
arithmetic).
"""

import os

import pytest

_ON_GPU = os.environ.get("EXSADDLE_TEST_GPU") == "1"
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from exsaddle_tpu.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)
# persistent XLA compilation cache: every test jits its own solver
# programs; across tests and across runs most are identical
enable_compile_cache()


@pytest.fixture
def gpu():
    """The first GPU device; skips where none is visible. Decided here, not
    at import, so every xdist worker collects the same tests."""
    if not _ON_GPU:
        pytest.skip("needs a GPU: EXSADDLE_TEST_GPU=1 on a machine with one")
    if os.environ.get("PYTEST_XDIST_WORKER"):
        pytest.skip("GPU tests run in one process (-p no:xdist): each "
                    "worker would reserve most of the card's memory")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("EXSADDLE_TEST_GPU=1 but JAX sees no GPU")
    return dev
