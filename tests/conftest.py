"""Test configuration.

Tests run on a virtual 8-device CPU mesh unless ``JAX_PLATFORMS`` says
otherwise: ``JAX_PLATFORMS=cpu`` is the default set here, before JAX is
imported. Tests that need a GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them when no GPU is present; run them
on a GPU host with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

# Tests recompile the same programs from changing code: a persistent cache
# could hand back an executable built from an older tree.
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (JAX found no gpu backend)")
