"""Test configuration: default to an 8-device virtual CPU mesh.

Multi-chip sharding paths are validated on a fake CPU backend
(``--xla_force_host_platform_device_count``), per the framework test
strategy (SURVEY.md §4): no accelerator is required to run the suite.
An existing ``JAX_PLATFORMS`` is kept, so the on-card tests (marker
``gpu``) run with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``
on a GPU machine; each of them decides inside its ``gpu_device`` fixture
whether a GPU is present and skips otherwise.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX sees none."""
    import jax

    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (run on the card: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/)")
    return devices[0]
