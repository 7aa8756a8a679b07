"""Test session setup: JAX on the host CPU with 8 virtual devices.

The tests run on XLA's CPU backend unless JAX_PLATFORMS names another
platform, and 8 virtual host devices give the sharded paths a mesh
(SURVEY.md §7.2 L5). The platform is also set through jax.config, in case
a plugin imported JAX before this file ran.

Tests marked `gpu` need an NVIDIA card: the `gpu` fixture skips them
unless JAX's default platform is a GPU. `python chip_smoke.py` runs their
checks (tests/gpu_checks.py) on a card.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def gpu():
    """Skip unless JAX's default platform is a GPU (decided per test, at
    run time — never while test modules are imported)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run `python chip_smoke.py` on one")
