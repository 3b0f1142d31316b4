"""Test env: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding is validated without GPUs the standard way
(SURVEY.md §4): fake 8 host devices, pinned to the CPU through jax.config
before any backend initializes.  Tests marked ``gpu`` (the CUDA kernel has
no interpret mode) skip there; chip_smoke.py runs them in its own process,
which has already opened the GPU, so the pin is left alone then.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
from jax._src import xla_bridge

if not xla_bridge.backends_are_initialized():
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip a ``gpu``-marked test unless JAX's default device is a GPU
    (decided per test, never at import: pytest-xdist workers must collect
    the same tests)."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no interpret "
                    "mode (chip_smoke.py runs these on the card)")
