"""Serving layer: warm bucket-pinned BatchVerifier."""

import numpy as np
import pytest

from zk_state_proofs_tpu.models import BatchVerifier
from zk_state_proofs_tpu.ops import mpt
from zk_state_proofs_tpu.oracle import EthTrie, keccak256
from zk_state_proofs_tpu.utils.config import BucketConfig
from zk_state_proofs_tpu.witness.pack import PackingError


def _trie(n=96, tag=b"svc"):
    t = EthTrie()
    keys = [keccak256(tag + b"-%d" % i) for i in range(n)]
    for i, k in enumerate(keys):
        t.insert(k, b"\x02" + bytes([i % 251]) * 40)
    return t, keys


def test_service_verify_pads_and_slices():
    t, keys = _trie()
    root = t.root_hash()
    svc = BatchVerifier(BucketConfig.account(), batch_size=128)
    svc.warmup()

    # 70-entry request in a 128-wide pinned batch: results sliced to 70
    entries = [(root, t.get_proof(k), k) for k in keys[:69]]
    absent = keccak256(b"nope")
    entries.append((root, t.get_proof(absent), absent))
    res = svc.verify(entries)
    assert len(res.status) == 70
    assert (res.status[:69] == mpt.FOUND).all()
    assert res.status[69] == mpt.EXCLUDED
    assert res.value(0) == b"\x02" + bytes([0]) * 40

    # stats accumulate across requests
    res2 = svc.verify(entries[:10])
    assert (res2.status == mpt.FOUND).all()
    assert svc.stats.batches == 2
    assert svc.stats.proofs == 80
    assert svc.stats.found == 79 and svc.stats.excluded == 1

    # a second service call reuses the pinned-jit shape: the pool bucket
    # derived at warmup must hold for later batches
    assert svc.pool_rows > 0


def test_service_rejects_oversized_batches_and_proofs():
    t, keys = _trie(8)
    root = t.root_hash()
    svc = BatchVerifier(BucketConfig.account(), batch_size=4)
    with pytest.raises(PackingError):
        svc.verify([(root, t.get_proof(k), k) for k in keys[:5]])
    tiny = BatchVerifier(
        BucketConfig(max_nodes=1, node_len=64, key_nibbles=64,
                     max_value_len=64), batch_size=4)
    with pytest.raises(PackingError):
        tiny.verify([(root, t.get_proof(keys[0]), keys[0])])


def test_service_sharded_matches_unsharded():
    from zk_state_proofs_tpu.parallel import make_mesh

    t, keys = _trie(64, tag=b"svc8")
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in keys]
    plain = BatchVerifier(BucketConfig.account(), batch_size=64)
    sharded = BatchVerifier(BucketConfig.account(), batch_size=64,
                            mesh=make_mesh())
    r1 = plain.verify(entries)
    r2 = sharded.verify(entries)
    np.testing.assert_array_equal(r1.status, r2.status)
    np.testing.assert_array_equal(r1.values, r2.values)
    np.testing.assert_array_equal(r1.value_lens, r2.value_lens)


def test_service_pinned_depth_segments_restore_request_order():
    """A pinned depth-segment schedule depth-sorts each request at pack
    time; results must come back in REQUEST order, bit-identical to the
    unsegmented service. Batches that do not fit the schedule must fall
    back to the unsegmented path (correctness, not an error)."""
    t, keys = _trie(96, tag=b"svcseg")
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in keys[:30]]
    absent = keccak256(b"svcseg-nope")
    entries.append((root, t.get_proof(absent), absent))
    # interleave depths: reverse-sort then shuffle deterministically
    import random

    random.Random(7).shuffle(entries)

    plain = BatchVerifier(BucketConfig.account(), batch_size=32)
    r1 = plain.verify(entries)

    # schedule from this batch's own (sorted) mix, at a small tile
    probe = plain.pack(sorted(entries, key=lambda e: -len(e[1])))
    segs = tuple()
    off = 0
    nn = probe.num_nodes
    for o in range(0, len(nn), 8):
        c = min(8, len(nn) - o)
        segs += ((c, max(int(nn[o:o + c].max()), 1)),)
    svc = BatchVerifier(BucketConfig.account(), batch_size=32,
                        depth_segments=segs)
    assert svc._compatible_segments(probe) == segs
    r2 = svc.verify(entries)
    np.testing.assert_array_equal(r1.status, r2.status)
    np.testing.assert_array_equal(r1.values, r2.values)
    np.testing.assert_array_equal(r1.value_lens, r2.value_lens)

    # schedule that cannot fit (d=1 everywhere) -> unsegmented fallback,
    # same results
    bad = BatchVerifier(BucketConfig.account(), batch_size=32,
                        depth_segments=((32, 1),))
    assert bad._compatible_segments(probe) is None
    r3 = bad.verify(entries)
    np.testing.assert_array_equal(r1.status, r3.status)
    np.testing.assert_array_equal(r1.values, r3.values)


def test_service_warmup_compiles_both_segment_executables():
    """With a pinned depth_segments schedule, warmup must compile BOTH
    the segmented executable and the unsegmented fallback: the first
    schedule-miss request must trigger NO new XLA compile (a cold compile
    takes seconds to minutes — never acceptable mid-serving)."""
    t, keys = _trie(48, tag=b"svcwarm")
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in keys[:32]]

    # a schedule the (depth-sorted) 32-batch fits
    probe_svc = BatchVerifier(BucketConfig.account(), batch_size=32)
    probe = probe_svc.pack(sorted(entries, key=lambda e: -len(e[1])))
    nn = probe.num_nodes
    segs = tuple()
    for o in range(0, len(nn), 16):
        c = min(16, len(nn) - o)
        segs += ((c, max(int(nn[o:o + c].max()), 1)),)

    svc = BatchVerifier(BucketConfig.account(), batch_size=32,
                        depth_segments=segs)
    svc.warmup(entries)

    before = mpt.verify_proofs_pooled._cache_size()
    # hit: fits the pinned schedule
    r_hit = svc.verify(entries)
    # miss: one proof deeper than segment 0's d (an absent key through a
    # branchy region still packs; simplest miss = wrong batch size is
    # rejected, so build a miss by breaking the segment bound instead)
    deep = BatchVerifier(BucketConfig.account(), batch_size=32,
                         depth_segments=((32, 1),))
    deep.pool_rows = svc.pool_rows  # same pinned bucket as svc
    deep._warm = True  # serving without its own warmup: executables must
    #                    already be covered by svc's warmup compiles
    r_miss = deep.verify(entries)
    after = mpt.verify_proofs_pooled._cache_size()
    assert after == before, (
        f"serving compiled a new executable ({before} -> {after})")
    assert (r_hit.status == mpt.FOUND).all()
    np.testing.assert_array_equal(r_hit.status, r_miss.status)
    np.testing.assert_array_equal(r_hit.values, r_miss.values)


def test_service_pinned_pool_segments_hit_and_miss():
    """A pinned segmented-pool-hash schedule must serve fitting batches
    through the segmented executable and fall back (zero new compiles)
    on batches whose pool doesn't fit it — results bit-identical to the
    unsegmented service either way."""
    t, keys = _trie(64, tag=b"svcps")
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in keys[:32]]

    plain = BatchVerifier(BucketConfig.account(), batch_size=32)
    r_ref = plain.verify(entries)

    probe = plain.pack(entries)
    psegs = probe.pool_block_segments()
    svc = BatchVerifier(BucketConfig.account(), batch_size=32,
                        pool_segments=psegs)
    svc.pool_rows = plain.pool_rows  # same pinned pool bucket
    svc.warmup(entries)
    assert svc._compatible_pool_segments(probe) == psegs

    before = mpt.verify_proofs_pooled._cache_size()
    r_hit = svc.verify(entries)
    np.testing.assert_array_equal(r_ref.status, r_hit.status)
    np.testing.assert_array_equal(r_ref.values, r_hit.values)

    # force a miss: shrink a segment width below the real max length
    squeezed = tuple((c, 8) for c, _ in psegs)
    miss = BatchVerifier(BucketConfig.account(), batch_size=32,
                         pool_segments=squeezed)
    miss.pool_rows = svc.pool_rows
    miss._warm = True  # rides svc's warmup: the fallback (ps=None)
    #                    executable must already be compiled
    assert miss._compatible_pool_segments(probe) is None
    r_miss = miss.verify(entries)
    after = mpt.verify_proofs_pooled._cache_size()
    assert after == before, (before, after)
    np.testing.assert_array_equal(r_ref.status, r_miss.status)
    np.testing.assert_array_equal(r_ref.values, r_miss.values)
    np.testing.assert_array_equal(r_ref.value_lens, r_miss.value_lens)
