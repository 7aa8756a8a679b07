"""Witness layer: golden receipt vector, tx/receipt trie round trips,
borsh wire compat, RPC clients against a fake transport."""

import numpy as np
import pytest

from zk_state_proofs_tpu.oracle import keccak256, rlp, verify_merkle_proof
from zk_state_proofs_tpu.ops import mpt
from zk_state_proofs_tpu.witness import (
    MerkleProofInput,
    StorageProofInput,
    WitnessError,
    encode_receipt,
    get_receipt_proof_input,
    get_transaction_proof_input,
    pack_proofs,
    synthetic_block,
)
from zk_state_proofs_tpu.witness.rpc import EthereumClient, JsonRpcClient, RpcError


# The reference's ONLY golden-vector test (trie-utils/tests/rlp.rs:10-42):
# receipt = [status=false, cumulative_gas=0x1, bloom=zeros, one log
# (address 0x..11, topics dead/beef, data 0x0100ff)], legacy envelope.
GOLDEN_RECEIPT_HEX = (
    "f901668001b90100" + "00" * 256 +
    "f85ff85d940000000000000000000000000000000000000011f842a0"
    "000000000000000000000000000000000000000000000000000000000000dead"
    "a0000000000000000000000000000000000000000000000000000000000000beef"
    "830100ff"
)


def test_golden_receipt_vector():
    receipt = {
        "type": "0x0",
        "status": "0x0",
        "cumulativeGasUsed": "0x1",
        "logsBloom": "0x" + "00" * 256,
        "logs": [
            {
                "address": "0x0000000000000000000000000000000000000011",
                "topics": [
                    "0x000000000000000000000000000000000000000000000000000000000000dead",
                    "0x000000000000000000000000000000000000000000000000000000000000beef",
                ],
                "data": "0x0100ff",
            }
        ],
    }
    assert encode_receipt(receipt).hex() == GOLDEN_RECEIPT_HEX


def test_transaction_proof_round_trip():
    fx = synthetic_block(num_txs=24, seed=3)
    block = fx["block"]
    for index in (0, 7, 15, 23):
        inp = get_transaction_proof_input(block, index)
        value = verify_merkle_proof(inp.root_hash, inp.proof, inp.key)
        from zk_state_proofs_tpu.witness import encode_transaction

        assert value == encode_transaction(block["transactions"][index])


def test_transaction_proof_device_batch():
    fx = synthetic_block(num_txs=16, seed=4)
    block = fx["block"]
    entries = []
    expected = []
    from zk_state_proofs_tpu.witness import encode_transaction

    for i in range(16):
        inp = get_transaction_proof_input(block, i)
        entries.append(inp.as_entry())
        expected.append(encode_transaction(block["transactions"][i]))
    max_len = max(max(len(n) for n in p) for _, p, _ in entries)
    packed = pack_proofs(entries, key_nibbles=16, node_len=max_len)
    status, values, vlens = mpt.verify_proofs(
        *packed.astuple(), max_value_len=max(len(v) for v in expected)
    )
    status = np.asarray(status)
    for i in range(16):
        assert status[i] == mpt.FOUND, (i, status[i])
        assert bytes(np.asarray(values)[i][: np.asarray(vlens)[i]]) == expected[i]


def test_receipt_proof_round_trip():
    fx = synthetic_block(num_txs=20, seed=5)
    block, receipts = fx["block"], fx["receipts"]
    inp = get_receipt_proof_input(block, receipts, 11)
    value = verify_merkle_proof(inp.root_hash, inp.proof, inp.key)
    assert value == encode_receipt(receipts[11])


def test_tampered_header_root_rejected():
    fx = synthetic_block(num_txs=8, seed=6)
    block = dict(fx["block"])
    block["transactionsRoot"] = "0x" + "11" * 32
    with pytest.raises(WitnessError):
        get_transaction_proof_input(block, 0)


def test_borsh_round_trip():
    m = MerkleProofInput(proof=[b"\x01\x02", b"", b"abc"], root_hash=b"\xaa" * 32, key=b"\x80")
    assert MerkleProofInput.from_borsh(m.to_borsh()) == m
    s = StorageProofInput(
        account_proof=[b"node1", b"node2"],
        storage_proofs=[[b"a"], [b"b", b"c"]],
        root_hash=b"\xbb" * 32,
        account_key=keccak256(b"addr"),
        storage_keys=[b"\x00" * 32, b"\x01" * 32],
        address_keccak=keccak256(b"addr"),
    )
    assert StorageProofInput.from_borsh(s.to_borsh()) == s
    # borsh layout spot-check: leading u32 count little-endian
    assert m.to_borsh()[:4] == (3).to_bytes(4, "little")


def test_rpc_client_fake_transport():
    calls = []

    def transport(url, payload):
        calls.append((url, payload))
        if payload["method"] == "eth_getBlockByHash":
            return {"jsonrpc": "2.0", "id": payload["id"], "result": {"number": "0x1"}}
        return {"jsonrpc": "2.0", "id": payload["id"], "error": {"code": -32000, "message": "nope"}}

    c = JsonRpcClient("http://example.invalid", transport=transport)
    assert c.get_block_by_hash("0xabc") == {"number": "0x1"}
    with pytest.raises(RpcError):
        c.get_proof("0x" + "00" * 20, [])
    assert calls[0][1]["params"] == ["0xabc", True]


def test_ethereum_client_requires_key(monkeypatch):
    monkeypatch.delenv("INFURA", raising=False)
    with pytest.raises(RuntimeError):
        EthereumClient()
    monkeypatch.setenv("INFURA", "test-key")
    c = EthereumClient(transport=lambda u, p: {"result": 1})
    assert c.url.endswith("test-key")


def test_packed_save_load(tmp_path):
    from zk_state_proofs_tpu.oracle import EthTrie

    t = EthTrie()
    for i in range(30):
        t.insert(keccak256(b"s%d" % i), b"val%d" % i)
    root = t.root_hash()
    entries = [(root, t.get_proof(keccak256(b"s%d" % i)), keccak256(b"s%d" % i)) for i in range(8)]
    packed = pack_proofs(entries)
    path = tmp_path / "witness.npz"
    packed.save(path)
    from zk_state_proofs_tpu.witness import PackedProofs

    loaded = PackedProofs.load(path)
    for a, b in zip(packed.astuple(), loaded.astuple()):
        assert (np.asarray(a) == np.asarray(b)).all()


def test_network_flavors_fake_transport():
    from zk_state_proofs_tpu.witness.networks import (
        NetworkEvm, get_account_proof_inputs, get_transaction_proof_inputs,
    )
    from zk_state_proofs_tpu.witness import WitnessError
    from zk_state_proofs_tpu.witness.rpc import ArbitrumClient, OptimismClient
    from zk_state_proofs_tpu.oracle import EthTrie

    # build a real account trie so the recorded 'RPC' responses verify
    t = EthTrie()
    addr = "0x" + "ab" * 20
    key = keccak256(bytes.fromhex("ab" * 20))
    leaf = rlp.encode([b"\x01", b"\x02", keccak256(b"sr"), keccak256(b"ch")])
    t.insert(key, leaf)
    for i in range(50):
        t.insert(keccak256(b"other%d" % i), rlp.encode([b"\x01", b"", b"", b""]))
    root = t.root_hash()
    proof_nodes = ["0x" + p.hex() for p in t.get_proof(key)]

    def transport(url, payload):
        if payload["method"] == "eth_getBlockByNumber":
            return {"result": {"stateRoot": "0x" + root.hex()}}
        if payload["method"] == "eth_getProof":
            # full eth_getProof shape (the typed AccountProofResult model
            # validates address/storageHash presence)
            return {"result": {
                "address": addr,
                "accountProof": proof_nodes,
                "balance": "0x2",
                "codeHash": "0x" + keccak256(b"ch").hex(),
                "nonce": "0x1",
                "storageHash": "0x" + keccak256(b"sr").hex(),
                "storageProof": [],
            }}
        raise AssertionError(payload["method"])

    client = OptimismClient(transport=transport)
    inp = get_account_proof_inputs(client, addr, NetworkEvm.OPTIMISM)
    assert verify_merkle_proof(inp.root_hash, inp.proof, inp.key) == leaf

    # Arbitrum tx proofs unsupported (reference parity)
    arb = ArbitrumClient(transport=transport)
    with pytest.raises(WitnessError):
        get_transaction_proof_inputs(arb, "0x00", 0, NetworkEvm.ARBITRUM)


def test_sweep_model():
    from zk_state_proofs_tpu.models import sweep, replicated_batches
    from zk_state_proofs_tpu.oracle import EthTrie

    t = EthTrie()
    keys = []
    for i in range(40):
        k = keccak256(b"sw%d" % i)
        keys.append(k)
        t.insert(k, b"v%d" % i)
    root = t.root_hash()
    packed = pack_proofs([(root, t.get_proof(k), k) for k in keys[:16]])
    res = sweep(replicated_batches(packed, 4))
    assert res.total == 64 and res.found == 64 and res.invalid == 0
    assert res.proofs_per_sec > 0


def test_optimism_deposit_tx_block():
    """OP deposit transactions (type 0x7e) get the manual envelope prefix
    (reference transaction.rs:93-97); a block mixing deposit + 1559 txs
    must rebuild to a consistent transactionsRoot and verify."""
    from zk_state_proofs_tpu.witness.builders import build_transaction_trie
    from zk_state_proofs_tpu.witness.encoding import encode_transaction

    deposit = {
        "type": "0x7e",
        "sourceHash": "0x" + "11" * 32,
        "from": "0x" + "22" * 20,
        "to": "0x" + "33" * 20,
        "mint": "0x0",
        "value": "0xde0b6b3a7640000",
        "gas": "0xf4240",
        "isSystemTx": False,
        "input": "0x",
    }
    enc = encode_transaction(deposit)
    assert enc[0] == 0x7E
    eip1559 = {
        "type": "0x2", "chainId": "0xa", "nonce": "0x1",
        "maxPriorityFeePerGas": "0x1", "maxFeePerGas": "0x2", "gas": "0x5208",
        "to": "0x" + "44" * 20, "value": "0x0", "input": "0xabcd",
        "yParity": "0x0", "r": "0x" + "55" * 32, "s": "0x" + "66" * 32,
    }
    txs = [deposit, eip1559]
    trie = build_transaction_trie(txs)
    root = trie.root_hash()
    block = {"transactions": txs, "transactionsRoot": "0x" + root.hex()}
    inp = get_transaction_proof_input(block, 0)
    assert verify_merkle_proof(inp.root_hash, inp.proof, inp.key) == enc


def test_sweep_resident_and_indexed_parity():
    """verify_proofs_indexed (device-resident pool) must agree with the
    pooled verifier, and sweep_resident must count identically to the
    fresh-stream sweep over the same index sets."""
    import numpy as np

    from zk_state_proofs_tpu.models import sweep_resident
    from zk_state_proofs_tpu.oracle import EthTrie
    from zk_state_proofs_tpu.ops import mpt

    t = EthTrie()
    keys = []
    for i in range(64):
        k = keccak256(b"res%d" % i)
        keys.append(k)
        t.insert(k, bytes([i % 250 + 1]) * 40)
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in keys]
    entries[7] = (root, t.get_proof(keccak256(b"gone")), keccak256(b"gone"))
    packed = pack_proofs(entries)
    pool = packed.pool()

    # op-level parity
    dig = mpt.hash_pool(pool[0], pool[1])
    s1, v1, l1 = (np.asarray(x) for x in mpt.verify_proofs_indexed(
        pool[0], pool[1], dig, pool[2], packed.num_nodes, packed.roots,
        packed.key_nibbles, packed.key_lens))
    s2, v2, l2 = (np.asarray(x) for x in mpt.verify_proofs_pooled(
        *packed.astuple(), *pool))
    assert (s1 == s2).all() and (l1 == l2).all() and (v1 == v2).all()
    assert s1[7] == mpt.EXCLUDED

    # sweep driver over index batches (with repeats across batches)
    rng = np.random.default_rng(3)
    sels = [rng.permutation(64)[:32] for _ in range(4)]
    res = sweep_resident(packed, sels, materialize=False)
    want_found = sum(int((s1[sel] == mpt.FOUND).sum()) for sel in sels)
    want_excl = sum(int((s1[sel] == mpt.EXCLUDED).sum()) for sel in sels)
    assert res.total == 128
    assert (res.found, res.excluded, res.invalid) == (want_found, want_excl, 0)

    # fused mode (whole sweep as one lax.scan dispatch) must count the same,
    # in both the materialized-table and pool-gather forms
    for materialize in (True, False):
        res_f = sweep_resident(packed, sels, fused=True,
                               materialize=materialize)
        assert res_f.total == 128 and res_f.batches == 4
        assert (res_f.found, res_f.excluded, res_f.invalid) == (
            want_found, want_excl, 0)
    res_m = sweep_resident(packed, sels, materialize=True)
    assert (res_m.found, res_m.excluded, res_m.invalid) == (
        want_found, want_excl, 0)

    # epoch sweep: E passes in contiguous windows, one dispatch; counts =
    # E * (window coverage including the overlapping tail window)
    from zk_state_proofs_tpu.models import sweep_resident_epochs

    res_e = sweep_resident_epochs(packed, epochs=3, batch=24)
    # windows: [0:24], [24:48], [40:64] (tail clamped) per epoch
    win = np.concatenate([np.arange(0, 24), np.arange(24, 48),
                          np.arange(40, 64)])
    assert res_e.total == 3 * 72 and res_e.batches == 9
    assert res_e.found == 3 * int((s1[win] == mpt.FOUND).sum())
    assert res_e.excluded == 3 * int((s1[win] == mpt.EXCLUDED).sum())
    assert res_e.invalid == 0


def test_pool_block_segments_hashing_parity():
    """Segmented pool hashing (one keccak call per contiguous block-count
    segment at its trimmed width, PackedProofs.pool_block_segments) must
    produce bit-identical digests and verification results to the
    unsegmented pool hash."""
    import numpy as np
    import jax.numpy as jnp

    from zk_state_proofs_tpu.oracle import EthTrie, keccak256, rlp
    from zk_state_proofs_tpu.ops import mpt

    t = EthTrie()
    keys = [keccak256(b"pbs-%d" % i) for i in range(96)]
    for i, k in enumerate(keys):
        t.insert(k, rlp.encode([rlp.int_to_min_bytes(i + 1), b"\x07",
                                keccak256(b"s%d" % i), keccak256(b"c%d" % i)]))
    root = t.root_hash()
    entries = [(root, t.get_proof(k), k) for k in keys]
    packed = pack_proofs(entries, node_len=576)
    pool = packed.pool()
    segs = packed.pool_block_segments()  # 1- and multi-block runs
    assert len(segs) >= 2
    assert sum(c for c, _ in segs) == pool[0].shape[0]
    # widths must cover every row's real length
    off = 0
    for cnt, w in segs:
        assert int(pool[1][off:off + cnt].max()) <= w
        off += cnt
    d1 = np.asarray(mpt._hash_pool_rows(
        jnp.asarray(pool[0]), jnp.asarray(pool[1])))
    d2 = np.asarray(mpt._hash_pool_rows(
        jnp.asarray(pool[0]), jnp.asarray(pool[1]), pool_segments=segs))
    np.testing.assert_array_equal(d1, d2)
    r1 = mpt.verify_proofs_pooled(*packed.astuple(), *pool)
    r2 = mpt.verify_proofs_pooled(*packed.astuple(), *pool,
                                  pool_segments=segs)
    for a, b in zip(r1, r2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (np.asarray(r1[0]) == mpt.FOUND).all()
