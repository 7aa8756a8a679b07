"""GPU Keccak sponge kernel (Pallas, Triton route) vs the oracle.

On the CPU the kernel runs in the Pallas interpreter, which executes the
kernel body the card compiles: per-row padding by length, the word-major
loads, the per-program block loop and the masked tail rows. The compiled
kernel is checked on a card by tests/test_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest

from zk_state_proofs_tpu.oracle import keccak256 as oracle_keccak
from zk_state_proofs_tpu.ops.keccak import keccak256 as xla_keccak
from zk_state_proofs_tpu.ops.keccak_gpu import keccak256_gpu

WIDTH = 2176  # the wide tx/receipt bucket: 17 rate blocks
BLOCK = 16    # rows per program in these tests (3 programs for 40 rows)


def _kernel(data, lengths=None):
    return np.asarray(keccak256_gpu(data, lengths, block=BLOCK,
                                    interpret=True))


def _oracle(data, lengths):
    return [oracle_keccak(bytes(data[i, :lengths[i]]))
            for i in range(len(lengths))]


@pytest.mark.parametrize(
    "length", [0, 1, 135, 136, 137, 271, 272, 532, 576, 2176])
def test_kernel_matches_oracle_at_length(length):
    """Every row of a 40-row batch at one length, around each padding edge:
    empty, the 0x81 combined pad byte (135), block boundaries (136, 272),
    the account bucket (576) and the full wide bucket."""
    rng = np.random.default_rng(length)
    data = rng.integers(0, 256, (40, WIDTH), dtype=np.uint8)
    lens = np.full(40, length, np.int32)
    out = _kernel(data, lens)
    assert [bytes(r) for r in out] == _oracle(data, lens)


def test_kernel_mixed_lengths_tail_rows():
    """50 rows (not a multiple of the 16-row block) whose block counts
    differ inside each program: rows that finish early keep their state
    while the program loops on, and the 2-row tail program is masked."""
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (50, WIDTH), dtype=np.uint8)
    lens = rng.integers(0, WIDTH + 1, 50).astype(np.int32)
    lens[:6] = [0, 2176, 1, 136, 135, 1500]
    out = _kernel(data, lens)
    assert [bytes(r) for r in out] == _oracle(data, lens)
    np.testing.assert_array_equal(out, np.asarray(xla_keccak(data, lens)))


def test_kernel_width_not_word_aligned_and_full_length():
    """A 33-byte bucket (padded to 36 in the wrapper) and the default
    lengths (= the full width)."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (7, 33), dtype=np.uint8)
    out = _kernel(data)
    assert [bytes(r) for r in out] == [oracle_keccak(bytes(r)) for r in data]


def test_kernel_keeps_leading_dims():
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (2, 3, 140), dtype=np.uint8)
    lens = np.asarray([[0, 70, 140], [136, 137, 3]], np.int32)
    out = _kernel(data, lens)
    assert out.shape == (2, 3, 32)
    np.testing.assert_array_equal(out, np.asarray(xla_keccak(data, lens)))


def test_kernel_empty_batch():
    out = _kernel(np.zeros((0, 576), np.uint8), np.zeros((0,), np.int32))
    assert out.shape == (0, 32)
