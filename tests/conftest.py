"""Test configuration: run everything on a virtual 8-device CPU mesh.

The reference engine (Dark565/raytracer.js) is single-threaded browser JS with
no device concept; all multi-device behavior in this framework is new
capability. Tests validate sharding semantics on fake CPU devices
(``xla_force_host_platform_device_count``). Device speed is measured by
bench.py and chip_smoke.py on the GPU, never here.

Tests marked ``gpu`` need an NVIDIA card: they take the ``gpu`` fixture,
which skips them on the CPU. On a machine with a card run them with
``RAYTRACER_TEST_GPU=1 python -m pytest -m gpu tests/`` (that variable
leaves JAX's platform choice alone).
"""
import os

import pytest

ON_GPU = os.environ.get("RAYTRACER_TEST_GPU") == "1"

# Must be set before jax initializes a backend. Force-override: unit
# correctness is checked on the CPU whatever accelerator the machine has.
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
import sys

if "jax" in sys.modules and not ON_GPU:
    # A pytest plugin (jaxtyping) imports jax before conftest runs, freezing
    # the env-derived config default; update it explicitly instead.
    import jax

    jax.config.update("jax_platforms", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if not ON_GPU and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")


@pytest.fixture
def gpu():
    """The first device, when it is an NVIDIA GPU; skips otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (RAYTRACER_TEST_GPU=1 python -m "
                    "pytest -m gpu tests/ on a machine with a card)")
    return dev
