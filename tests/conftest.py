"""Test configuration.

By default the tests run on the CPU, on a virtual 8-device mesh, so the
sharding logic is exercised without accelerators.  Tests that need the
GPU carry the `gpu` marker (registered in pytest.ini) and skip here;
run them on a machine with a card with

    python -m pytest --gpu -m gpu tests/

`--gpu` leaves JAX on its default platform instead of forcing the CPU.
The platform is chosen in pytest_configure, before any test module
imports jax.
"""

import os

import pytest


def pytest_addoption(parser):
    parser.addoption("--gpu", action="store_true", default=False,
                     help="run on the default JAX platform (the GPU) "
                          "instead of forcing the CPU")


def pytest_configure(config):
    if config.getoption("--gpu"):
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ.setdefault("JAX_ENABLE_X64", "0")

    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest --gpu -m gpu "
                    "tests/` on a machine with one")
