"""The XLA walker (the walk on every backend) against the oracle.

Fixtures cover the shapes the walk meets beyond plain account batches:
inline (<32 B) children, exclusion, corruption, truncation and shuffled
node order; the wide 2,176-byte tx/receipt bucket; a value window wider
than a tiny node buffer; crafted RLP that breaks the branch/pair size
bounds; every INVALID reason code; and the depth-segmented dispatch.
"""

import random

import numpy as np
import pytest

from zk_state_proofs_tpu.oracle import (EthTrie, MissingKeyError, TrieError,
                                        keccak256, rlp, verify_merkle_proof)
from zk_state_proofs_tpu.ops import mpt
from zk_state_proofs_tpu.witness import pack_proofs


def _oracle_outcome(root, proof, key):
    """(status, value) the batch walk must report for one entry."""
    try:
        return mpt.FOUND, verify_merkle_proof(root, proof, key)
    except MissingKeyError:
        return mpt.EXCLUDED, b""
    except TrieError:
        return mpt.INVALID, b""


def _assert_matches_oracle(entries, status, values, vlens):
    status, values, vlens = (np.asarray(x) for x in (status, values, vlens))
    for i, (root, proof, key) in enumerate(entries):
        want_status, want_value = _oracle_outcome(root, proof, key)
        assert status[i] == want_status, (i, status[i], want_status)
        assert bytes(values[i][:vlens[i]]) == want_value, i


def _pooled(packed, **kw):
    return mpt.verify_proofs_pooled(*packed.astuple(), *packed.pool(), **kw)


def test_mixed_inline_fixture_matches_oracle():
    t = EthTrie()
    keys = []
    for i in range(48):
        k = keccak256(b"pallas-%d" % i)[:6]
        t.insert(k, rlp.int_to_min_bytes(i + 1))  # small values -> inline
        keys.append(k)
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in keys[:12]]
    absent = b"\xfe" * 6
    entries.append((root, t.get_proof(absent), absent))        # EXCLUDED
    bad = [bytearray(x) for x in t.get_proof(keys[0])]
    bad[0][5] ^= 1
    entries.append((root, [bytes(x) for x in bad], keys[0]))   # corrupted
    entries.append((root, t.get_proof(keys[1])[:-1], keys[1]))  # truncated
    proof = list(t.get_proof(keys[2]))
    random.Random(0).shuffle(proof)
    entries.append((root, proof, keys[2]))                     # shuffled
    packed = pack_proofs(entries)
    out = _pooled(packed, max_value_len=64)
    _assert_matches_oracle(entries, *out)
    assert [int(s) for s in np.asarray(out[0])[12:]] == [
        mpt.EXCLUDED, mpt.INVALID, mpt.INVALID, mpt.FOUND]


def test_wide_2176_bucket_matches_oracle():
    """Tx/receipt geometry: ~2 KB leaf values in a 2,080-byte node bucket,
    extracted at full width (max_value_len 2048)."""
    t = EthTrie()
    keys = []
    for i in range(48):
        k = rlp.encode_int(i)
        t.insert(k, b"\x44" * (1800 + 13 * i))
        keys.append(k)
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in keys[:3]]
    absent = rlp.encode_int(999)
    entries.append((root, t.get_proof(absent), absent))
    packed = pack_proofs(entries, node_len=2080, key_nibbles=8)
    out = mpt.verify_proofs(*packed.astuple(), max_value_len=2048)
    _assert_matches_oracle(entries, *out)
    assert (np.asarray(out[0])[:3] == mpt.FOUND).all()


def test_value_window_wider_than_tiny_node_buffer():
    """A one-leaf storage trie: its only node (~43 B) is narrower than
    the 64-byte value window the extraction fetches."""
    st = EthTrie()
    slot = bytes(32)
    val = rlp.encode_int(39_035_000_000_000)
    st.insert(keccak256(slot), val)
    root = st.root_hash()
    proof = st.get_proof(keccak256(slot))
    assert len(proof) == 1 and len(proof[0]) < 64
    entries = [(root, proof, keccak256(slot))]
    packed = pack_proofs(entries)
    assert packed.nodes.shape[2] < 64
    out = mpt.verify_proofs(*packed.astuple(), max_value_len=64)
    _assert_matches_oracle(entries, *out)
    assert bytes(np.asarray(out[1])[0][:int(np.asarray(out[2])[0])]) == val


def test_crafted_oversized_items_match_oracle():
    """Well-formed RLP whose items exceed the usual branch/pair sizes: a
    2-item list with a 100-byte path and a 17-item list of 40-byte items,
    each referenced as a proof's root."""
    t = EthTrie()
    keys = [keccak256(b"ovf-%d" % i) for i in range(8)]
    for i, k in enumerate(keys):
        t.insert(k, b"v%d" % i)
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in keys[:4]]
    crafted = rlp.encode([b"\x11" * 100, b"\x22"])
    entries.append((keccak256(crafted), [crafted], keys[0]))
    crafted2 = rlp.encode([b"\x33" * 40] * 17)
    entries.append((keccak256(crafted2), [crafted2], keys[1]))
    packed = pack_proofs(entries)
    out = mpt.verify_proofs(*packed.astuple())
    _assert_matches_oracle(entries, *out)


def _reason_entries():
    t = EthTrie()
    keys = [keccak256(b"reason-%d" % i) for i in range(32)]
    for i, k in enumerate(keys):
        t.insert(k, b"\x05" + bytes([i]) * 40)  # >=32 B values: hashed children
    root = t.root_hash()
    entries = [(root, t.get_proof(keys[0]), keys[0])]             # FOUND
    absent = keccak256(b"nope")
    entries.append((root, t.get_proof(absent), absent))            # EXCLUDED
    entries.append((b"\x13" * 32, t.get_proof(keys[1]), keys[1]))  # root missing
    entries.append((root, t.get_proof(keys[2])[:1], keys[2]))      # hash mismatch
    crafted = rlp.encode([b"\x01"])
    entries.append((keccak256(crafted), [crafted], keys[3]))       # malformed
    branch = [b""] * 17
    branch[keys[4][0] >> 4] = b"\x07" * 31
    crafted2 = rlp.encode(branch)
    entries.append((keccak256(crafted2), [crafted2], keys[4]))     # bad child ref
    return entries


def test_reason_codes_match_oracle_outcomes():
    from zk_state_proofs_tpu.models import diagnose_batch

    entries = _reason_entries()
    packed = pack_proofs(entries)
    res = diagnose_batch(packed)
    _assert_matches_oracle(entries, res.status, res.values, res.value_lens)
    assert list(res.reasons) == [
        mpt.R_NONE, mpt.R_NONE, mpt.R_ROOT_MISSING, mpt.R_HASH_MISMATCH,
        mpt.R_MALFORMED, mpt.R_BAD_CHILD_REF]
    counts = res.counts()
    for name in ("root-missing", "hash-mismatch", "malformed-node",
                 "bad-child-ref"):
        assert counts[f"invalid_{name}"] == 1, counts
    # step exhaustion -> R_TRUNCATED
    _, _, _, reasons = mpt.verify_proofs_diagnose(*packed.astuple(),
                                                  max_steps=1)
    assert int(np.asarray(reasons)[0]) == mpt.R_TRUNCATED


@pytest.mark.parametrize("max_steps", [None, "depth"])
def test_depth_segmented_dispatch_equals_unsegmented(max_steps):
    """verify_proofs_pooled(depth_segments=...) walks each contiguous
    depth segment with its node axis sliced to the segment's d; results
    must equal the unsegmented call and the oracle, failures included.
    max_steps=None must resolve from the GLOBAL node axis."""
    t = EthTrie()
    keys = [keccak256(b"seg-%d" % i) for i in range(96)]
    for i, k in enumerate(keys):
        t.insert(k, b"\x09" + bytes([i]) * 40)
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in keys[:24]]
    absent = keccak256(b"seg-absent")
    entries.append((root, t.get_proof(absent), absent))            # EXCLUDED
    entries.append((b"\x31" * 32, t.get_proof(keys[1]), keys[1]))  # root miss
    entries.sort(key=lambda e: -len(e[1]))  # the bench/serving batch order
    packed = pack_proofs(entries)
    segs = packed.depth_segments(rows=8)
    assert len(segs) >= 2
    assert sum(c for c, _ in segs) == packed.batch
    off = 0
    for cnt, dseg in segs:  # segment d bounds every num_nodes inside it
        assert int(packed.num_nodes[off:off + cnt].max()) <= dseg
        off += cnt
    steps = None if max_steps is None else packed.nodes.shape[1]
    ref = _pooled(packed, max_steps=steps)
    out = _pooled(packed, max_steps=steps, depth_segments=segs)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _assert_matches_oracle(entries, *out)


def test_depth_segments_cover_batch_in_rows_steps():
    t = EthTrie()
    keys = [keccak256(b"dsr-%d" % i) for i in range(40)]
    for i, k in enumerate(keys):
        t.insert(k, b"\x0a" * 40)
    root = t.root_hash()
    entries = sorted(((root, t.get_proof(k), k) for k in keys),
                     key=lambda e: -len(e[1]))
    packed = pack_proofs(entries)
    segs = packed.depth_segments(rows=16)
    assert sum(c for c, _ in segs) == 40
    assert len(segs) <= 3  # at most ceil(40 / 16) runs
    assert all(c % 16 == 0 for c, _ in segs[:-1])
    assert [d for _, d in segs] == sorted((d for _, d in segs), reverse=True)


def test_pool_block_segments_are_exact_runs():
    """Segments follow the length-sorted pool's block-count runs exactly:
    they cover every row, each width is word-aligned and fits its rows,
    and no two neighbours share a width."""
    t = EthTrie()
    keys = [keccak256(b"pbr-%d" % i) for i in range(64)]
    for i, k in enumerate(keys):
        t.insert(k, rlp.encode([rlp.int_to_min_bytes(i + 1), b"\x07",
                                keccak256(b"s%d" % i), keccak256(b"c%d" % i)]))
    root = t.root_hash()
    packed = pack_proofs([(root, t.get_proof(k), k) for k in keys],
                         node_len=576)
    _, lens, _ = packed.pool()
    segs = packed.pool_block_segments()
    assert sum(c for c, _ in segs) == len(lens)
    off = 0
    for cnt, w in segs:
        assert w % 4 == 0 and int(lens[off:off + cnt].max()) <= w
        off += cnt
    assert all(a[1] != b[1] for a, b in zip(segs, segs[1:]))
