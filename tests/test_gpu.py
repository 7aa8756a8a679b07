"""Parity on an NVIDIA card (marker `gpu`; skipped without one).

Run on a card with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`;
chip_smoke.py runs the same checks (tests/gpu_checks.py) in its process.
"""

import pytest

import gpu_checks

pytestmark = pytest.mark.gpu


def test_keccak_kernel_compiled_matches_references(gpu):
    gpu_checks.check_keccak_kernel()


def test_pooled_walk_on_card_matches_oracle(gpu):
    gpu_checks.check_walk_small()
