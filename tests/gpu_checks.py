"""Checks that need an NVIDIA card: each compiled kernel of the hot path
against its plain reference at real widths, compared exactly.

tests/test_gpu.py runs them under pytest on a card (`gpu` marker), and
chip_smoke.py calls the same functions in its own process. Each raises
AssertionError on a mismatch and returns a short summary.
"""

from __future__ import annotations

import numpy as np

# (width in bytes, rows): the account bucket at the 4096-account pool's
# size, the wide tx/receipt bucket, and one-block messages (slot keys)
KECCAK_SHAPES = ((576, 5632), (2176, 4096), (32, 4096))


def check_keccak_kernel(shapes=KECCAK_SHAPES, seed: int = 0) -> list:
    """Compiled GPU sponge vs the XLA sponge on every row, and vs the C++
    host Keccak on a sample, at lengths that cover every padding edge."""
    import jax

    from zk_state_proofs_tpu import native
    from zk_state_proofs_tpu.ops.keccak import keccak256 as xla_keccak
    from zk_state_proofs_tpu.ops.keccak_gpu import keccak256_gpu

    assert jax.default_backend() == "gpu", jax.default_backend()
    rng = np.random.default_rng(seed)
    out = []
    for width, rows in shapes:
        data = rng.integers(0, 256, (rows, width), dtype=np.uint8)
        lens = rng.integers(0, width + 1, rows).astype(np.int32)
        edges = [e for e in (0, 1, 135, 136, 137, 271, 272, width)
                 if e <= width]
        lens[:len(edges)] = edges
        got = np.asarray(keccak256_gpu(data, lens))
        want = np.asarray(jax.jit(xla_keccak)(data, lens))
        mism = int((got != want).any(axis=1).sum())
        assert mism == 0, f"{mism} of {rows} rows differ at width {width}"
        sample = list(range(0, rows, max(1, rows // 256)))
        host = native.keccak256_batch(
            [bytes(data[i, :lens[i]]) for i in sample])
        assert [bytes(got[i]) for i in sample] == host, width
        out.append({"width": width, "rows": rows,
                    "equal_rows_vs_xla": rows, "equal_rows_vs_cpp":
                    len(sample)})
    return out


def check_walk_small() -> dict:
    """The pooled verifier on the card (GPU sponge + XLA walk) against the
    oracle on a small trie with EXCLUDED and INVALID rows."""
    import jax

    from zk_state_proofs_tpu.ops import mpt
    from zk_state_proofs_tpu.oracle import (EthTrie, MissingKeyError,
                                            TrieError, keccak256,
                                            verify_merkle_proof)
    from zk_state_proofs_tpu.witness import pack_proofs

    assert jax.default_backend() == "gpu", jax.default_backend()
    t = EthTrie()
    keys = [keccak256(b"gpu-check-%d" % i) for i in range(256)]
    for i, k in enumerate(keys):
        t.insert(k, b"\x01" + bytes([i % 251]) * (20 + i % 50))
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in keys[:120]]
    absent = keccak256(b"gpu-check-absent")
    entries.append((root, t.get_proof(absent), absent))
    bad = [bytearray(x) for x in t.get_proof(keys[3])]
    bad[-1][-1] ^= 1
    entries.append((root, [bytes(x) for x in bad], keys[3]))
    packed = pack_proofs(entries, node_len=576)
    status, values, vlens = (np.asarray(x) for x in mpt.verify_proofs_pooled(
        *packed.astuple(), *packed.pool()))
    for i, (r, proof, key) in enumerate(entries):
        try:
            want = (mpt.FOUND, verify_merkle_proof(r, proof, key))
        except MissingKeyError:
            want = (mpt.EXCLUDED, b"")
        except TrieError:
            want = (mpt.INVALID, b"")
        got = (int(status[i]), bytes(values[i][:vlens[i]]))
        assert got == want, (i, got, want)
    return {"proofs": len(entries), "equal_vs_oracle": len(entries)}
