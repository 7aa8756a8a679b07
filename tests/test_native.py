"""Native C++ host library vs Python oracle (keccak + packing parity)."""

import numpy as np
import pytest

from zk_state_proofs_tpu import native
from zk_state_proofs_tpu.oracle import EthTrie, keccak256 as py_keccak


requires_native = pytest.mark.skipif(
    not native.available(), reason="native library unavailable (no g++?)"
)


@requires_native
def test_native_keccak_matches_oracle():
    msgs = [b"", b"abc", b"x" * 135, b"y" * 136, b"z" * 1000]
    for m in msgs:
        assert native.keccak256(m) == py_keccak(m)
    batch = native.keccak256_batch(msgs)
    for m, d in zip(msgs, batch):
        assert d == py_keccak(m)


@requires_native
def test_native_pack_matches_python():
    import zk_state_proofs_tpu.witness.pack as pack_mod
    from zk_state_proofs_tpu.witness import pack_proofs

    t = EthTrie()
    kvs = {}
    for i in range(60):
        k = py_keccak(b"n%d" % i)
        v = b"v%d" % i
        kvs[k] = v
        t.insert(k, v)
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in list(kvs)[:20]]

    nat = pack_proofs(entries)  # native path (available)
    # force the pure-Python path for comparison
    orig = native.pack_proofs_native
    try:
        native.pack_proofs_native = lambda *a, **k: None
        py = pack_proofs(entries)
    finally:
        native.pack_proofs_native = orig

    for a, b in zip(nat.astuple(), py.astuple()):
        assert a.dtype == b.dtype
        assert (np.asarray(a) == np.asarray(b)).all()


@requires_native
def test_native_pack_bucket_overflow():
    from zk_state_proofs_tpu.witness import pack_proofs

    entries = [(b"\x00" * 32, [b"\x01" * 100], b"\x02" * 4)]
    with pytest.raises(ValueError):
        pack_proofs(entries, node_len=50)


def test_native_node_pool_matches_python():
    """zkp_build_node_pool must be byte-identical to the Python fallback
    (same stable length-descending row order, zero row 0, pad-to-128
    rows). Compared against pack.build_node_pool with the native path
    disabled — one source of truth for the reference semantics."""
    import numpy as np

    from zk_state_proofs_tpu import native
    import zk_state_proofs_tpu.witness.pack as pack_mod
    from zk_state_proofs_tpu.oracle import EthTrie, keccak256, rlp
    from zk_state_proofs_tpu.witness import pack_proofs

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")

    t = EthTrie()
    keys = [keccak256(b"np%d" % i) for i in range(96)]
    for i, k in enumerate(keys):
        t.insert(k, rlp.encode([rlp.int_to_min_bytes(i + 1), b"\x09",
                                keccak256(b"s%d" % i), keccak256(b"c%d" % i)]))
    root = t.root_hash()
    # repeats + an empty-proof row exercise dedup and the zero-row mapping
    entries = [(root, t.get_proof(keys[i % 96]), keys[i % 96])
               for i in range(256)]
    packed = pack_proofs(entries)
    packed.num_nodes[7] = 0  # empty proof -> all rows map to pool row 0

    nat = native.build_node_pool_native(
        packed.nodes, packed.node_lens, packed.num_nodes)
    assert nat is not None

    orig = native.build_node_pool_native
    try:
        native.build_node_pool_native = lambda *a, **k: None
        pn, pl, idx = pack_mod.build_node_pool(
            packed.nodes, packed.node_lens, packed.num_nodes)
    finally:
        native.build_node_pool_native = orig

    np.testing.assert_array_equal(nat[0], pn)
    np.testing.assert_array_equal(nat[1], pl)
    np.testing.assert_array_equal(nat[2], idx)
    assert (nat[2][7] == 0).all()
    # rows 1.. are length-sorted descending (keccak tile block-skip relies
    # on this); row 0 stays the zero row
    assert pl[0] == 0
    assert (np.diff(pl[1:]) <= 0).all()


def test_native_build_from_source_is_atomic(tmp_path):
    """The library builds from the committed source into its target by
    rename: no temporary file is left beside it, and it loads."""
    import ctypes

    target = tmp_path / "libzkp_host.so"
    if not native._build(target):
        pytest.skip("no C++ compiler")
    assert target.exists()
    assert [p.name for p in tmp_path.iterdir()] == ["libzkp_host.so"]
    lib = ctypes.CDLL(str(target))
    assert hasattr(lib, "zkp_keccak256")
    assert not hasattr(lib, "zkp_item_offsets")
