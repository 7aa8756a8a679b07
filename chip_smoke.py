"""Smoke test of the verifier on one NVIDIA GPU, through its user entry points.

    python chip_smoke.py             # one card: phases 0-5 + the gpu checks
    python chip_smoke.py --chips 4   # four cards: the sharded paths only

Every phase compares exactly (status, reason and value bytes), never within
a tolerance, and any mismatch or error exits non-zero. Witnesses are built
from seeded synthetic tries with the C++ host Keccak.

  0. platform: refuses anything but a GPU; prints the card, JAX, devices
  1. serving: BatchVerifier(BucketConfig.account(), batch_size=4096) over
     4096 distinct accounts of a 65,536-account trie, with absent keys
     (EXCLUDED) and tampered nodes (INVALID); values vs the trie, a sample
     vs the oracle, and diagnose_batch reason codes on the tampered rows
  2. storage: verify_storage_grouped, 512 accounts x 8 slots, vs the tries
  3. blocks: verify_block_transactions / verify_block_receipts on a
     256-tx synthetic block; ERC20 transfers vs the fixture's logs
  4. resident sweep: sweep_resident_epochs, 65,536 accounts x 16 epochs
  5. keccak: the GPU sponge vs the XLA sponge and the C++ host Keccak
     (tests/gpu_checks.py, the checks behind the `gpu`-marked tests)

With --chips 4 the script runs verify_proofs_sharded,
verify_storage_grouped_sharded, compute_root_sharded and
sweep_resident_epochs(mesh=) on a 4-device mesh, each compared bit for bit
with its one-device result, and nothing else.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 20261016
N_ACCOUNTS = 65536
BATCH = 4096
N_ABSENT = 64
N_TAMPERED = 64


def log(msg):
    print(msg, flush=True)


def require_gpu():
    """Phase 0 gate: exit non-zero unless JAX's default platform is a GPU."""
    import jax

    platform = jax.default_backend()
    if platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {platform!r})",
              file=sys.stderr)
        raise SystemExit(2)


def phase0(chips: int):
    import jax

    require_gpu()
    from zk_state_proofs_tpu import native
    from zk_state_proofs_tpu.utils.compile_cache import enable_compile_cache

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    for line in smi.stdout.strip().splitlines():
        log(f"card: {line.strip()}")
    log(f"jax {jax.__version__}  devices {jax.devices()}")
    if len(jax.devices()) < chips:
        raise SystemExit(f"need {chips} devices, have {len(jax.devices())}")
    log(f"compile cache: {enable_compile_cache()}")
    assert native.available(), "native host library did not build"
    log(f"native host library built from source in this run: "
        f"{native.built_from_source}")


class Phase:
    """Times a phase and prints its outcome line."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        log(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: ok in {time.time() - self.t0:.1f} s")


def account_world(n_accounts=None):
    """Seeded account trie: key -> RLP account leaf; returns (trie, keys,
    leaves)."""
    n_accounts = N_ACCOUNTS if n_accounts is None else n_accounts
    from zk_state_proofs_tpu import native
    from zk_state_proofs_tpu.oracle import EthTrie, rlp

    nk = native.keccak256
    trie = EthTrie(hasher=nk)
    keys, leaves = [], []
    for i in range(n_accounts):
        k = nk(b"smoke-acct-%d-%d" % (SEED, i))
        leaf = rlp.encode([rlp.int_to_min_bytes(i + 1),
                           rlp.int_to_min_bytes(10**18 + i),
                           nk(b"sr%d" % i), nk(b"ch%d" % i)])
        trie.insert(k, leaf)
        keys.append(k)
        leaves.append(leaf)
    return trie, keys, leaves


def _tamper(proof, at):
    """Flip the last byte of node `at` (inside its last item, so the RLP
    stays well formed and only the hash link breaks)."""
    nodes = [bytearray(x) for x in proof]
    nodes[at][-1] ^= 0x01
    return [bytes(x) for x in nodes]


def phase1_serving(world):
    from zk_state_proofs_tpu import native
    from zk_state_proofs_tpu.models import BatchVerifier, diagnose_batch
    from zk_state_proofs_tpu.ops import mpt
    from zk_state_proofs_tpu.oracle import (MissingKeyError, TrieError,
                                            verify_merkle_proof)
    from zk_state_proofs_tpu.utils.config import BucketConfig
    from zk_state_proofs_tpu.witness import pack_proofs

    trie, keys, leaves = world
    root = trie.root_hash()
    rng = np.random.default_rng(SEED)
    pick = rng.choice(len(keys), BATCH - N_ABSENT, replace=False)
    entries, want = [], []
    for i in pick:
        entries.append((root, trie.get_proof(keys[i]), keys[i]))
        want.append((mpt.FOUND, leaves[i]))
    for j in range(N_ABSENT):
        k = native.keccak256(b"smoke-absent-%d" % j)
        entries.append((root, trie.get_proof(k), k))
        want.append((mpt.EXCLUDED, b""))
    # tampered rows: half at the leaf (hash-mismatch), half at the root
    # node (root-missing); they replace found rows so the batch stays 4096
    tampered, reasons = [], []
    for j in range(N_TAMPERED):
        r, proof, k = entries[j]
        at = len(proof) - 1 if j % 2 == 0 else 0
        entries[j] = (r, _tamper(proof, at), k)
        want[j] = (mpt.INVALID, b"")
        tampered.append(entries[j])
        reasons.append(mpt.R_HASH_MISMATCH if at else mpt.R_ROOT_MISSING)
    order = rng.permutation(len(entries))
    entries = [entries[i] for i in order]
    want = [want[i] for i in order]

    # warm with another batch of distinct accounts: it sizes the pinned
    # unique-node pool bucket (the synthetic default is too small for a
    # distinct-account batch) and compiles the one executable
    rest = np.setdiff1d(np.arange(len(keys)), pick)[:BATCH]
    example = [(root, trie.get_proof(keys[i]), keys[i]) for i in rest]
    svc = BatchVerifier(BucketConfig.account(), batch_size=BATCH)
    t0 = time.time()
    svc.warmup(example)
    log(f"warmup (compile + first run): {time.time() - t0:.1f} s, "
        f"pool bucket {svc.pool_rows} rows")
    t0 = time.time()
    res = svc.verify(entries)
    log(f"verify {len(entries)} proofs: {time.time() - t0:.3f} s "
        f"(packing included) counts {res.counts()}")
    got = [(int(res.status[i]), res.value(i)) for i in range(len(entries))]
    bad = [i for i in range(len(entries)) if got[i] != want[i]]
    assert not bad, f"{len(bad)} rows differ from the trie, first {bad[:5]}"
    log(f"status + value bytes equal the trie contents: {len(entries)} rows "
        f"({BATCH - N_ABSENT - N_TAMPERED} FOUND, {N_ABSENT} EXCLUDED, "
        f"{N_TAMPERED} INVALID)")
    for i in range(0, len(entries), len(entries) // 64):
        try:
            o = (mpt.FOUND, verify_merkle_proof(*entries[i]))
        except MissingKeyError:
            o = (mpt.EXCLUDED, b"")
        except TrieError:
            o = (mpt.INVALID, b"")
        assert got[i] == o, (i, got[i], o)
    log("sample of 64 rows equals the Python oracle")
    diag = diagnose_batch(pack_proofs(tampered, max_nodes=12, node_len=576))
    assert (diag.status == mpt.INVALID).all(), diag.status
    assert list(diag.reasons) == reasons, (list(diag.reasons), reasons)
    log(f"diagnose_batch reason codes on {len(tampered)} tampered rows "
        f"equal the expected codes: {diag.counts()}")


def storage_world(n_accounts=512, slots_per=8, slots_in_trie=64):
    """A accounts with their own storage tries; each account requests
    `slots_per` slots, the last of every 64th account an absent one."""
    from zk_state_proofs_tpu import native
    from zk_state_proofs_tpu.oracle import EthTrie, rlp
    from zk_state_proofs_tpu.witness import pack_proofs

    nk = native.keccak256
    world = EthTrie(hasher=nk)
    sroots, s_entries, slots, owners, want = [], [], [], [], []
    for a in range(n_accounts):
        st = EthTrie(hasher=nk)
        raw = [a.to_bytes(16, "big") + i.to_bytes(16, "big")
               for i in range(slots_in_trie)]
        vals = [rlp.encode_int((a << 20) + i + 1) for i in range(len(raw))]
        for rs, v in zip(raw, vals):
            st.insert(nk(rs), v)
        sroots.append(st.root_hash())
        chosen = list(range(0, slots_in_trie, slots_in_trie // slots_per))
        for n, i in enumerate(chosen[:slots_per]):
            if a % 64 == 0 and n == slots_per - 1:
                rs, v = b"\xee" * 32, b""  # absent slot
            else:
                rs, v = raw[i], vals[i]
            s_entries.append((sroots[a], st.get_proof(nk(rs)), nk(rs)))
            slots.append(rs)
            owners.append(a)
            want.append(v)
    keys = [nk(b"smoke-storage-acct-%d" % a) for a in range(n_accounts)]
    for a, k in enumerate(keys):
        world.insert(k, rlp.encode([rlp.int_to_min_bytes(a + 1),
                                    rlp.int_to_min_bytes(10**18 + a),
                                    sroots[a], nk(b"code%d" % a)]))
    wroot = world.root_hash()
    ap = pack_proofs([(wroot, world.get_proof(k), k) for k in keys],
                     node_len=576)
    sp = pack_proofs(s_entries, node_len=576)
    slots = np.frombuffer(b"".join(slots), np.uint8).reshape(-1, 32)
    return ap, sp, slots, np.asarray(owners, np.int32), sroots, want


def phase2_storage(sworld):
    from zk_state_proofs_tpu.models import verify_storage_grouped
    from zk_state_proofs_tpu.ops import mpt

    ap, sp, slots, owners, sroots, want = sworld
    t0 = time.time()
    res = verify_storage_grouped(ap, sp, slots, owners)
    log(f"verify_storage_grouped {ap.batch} accounts x "
        f"{sp.batch // ap.batch} slots: {time.time() - t0:.1f} s "
        f"(compile included)")
    assert (res.account_status == mpt.FOUND).all()
    assert [bytes(r) for r in res.storage_root] == sroots
    got = [(int(res.slot_status[j]), res.slot_value(j))
           for j in range(sp.batch)]
    exp = [(mpt.FOUND if v else mpt.EXCLUDED, v) for v in want]
    bad = [j for j in range(sp.batch) if got[j] != exp[j]]
    assert not bad, f"{len(bad)} slots differ, first {bad[:5]}"
    log(f"account status + storage roots + {sp.batch} slot statuses and "
        f"values equal the tries ({sum(1 for v in want if not v)} "
        f"EXCLUDED)")
    return res


def phase3_blocks():
    from zk_state_proofs_tpu.models import (verify_block_receipts,
                                            verify_block_transactions)
    from zk_state_proofs_tpu.witness import synthetic_block
    from zk_state_proofs_tpu.witness.encoding import (encode_receipt,
                                                      encode_transaction)
    from zk_state_proofs_tpu.witness.fixtures import ERC20_TRANSFER_TOPIC

    fx = synthetic_block(num_txs=256, seed=SEED % 1000)
    block, receipts = fx["block"], fx["receipts"]
    t0 = time.time()
    res = verify_block_transactions(block)
    assert res.all_found, res.counts()
    for i, tx in enumerate(block["transactions"]):
        assert res.value(i) == encode_transaction(tx), i
    rres, transfers = verify_block_receipts(block, receipts)
    assert rres.all_found, rres.counts()
    for i, r in enumerate(receipts):
        assert rres.value(i) == encode_receipt(r), i
    want = []
    for i, r in enumerate(receipts):
        for lg in r["logs"]:
            if lg["topics"][0] == ERC20_TRANSFER_TOPIC and len(lg["topics"]) == 3:
                want.append((bytes.fromhex(lg["address"][2:]),
                             bytes.fromhex(lg["topics"][1][-40:]),
                             bytes.fromhex(lg["topics"][2][-40:]),
                             int(lg["data"], 16), i))
    got = [(t.token, t.sender, t.receiver, t.amount, t.tx_index)
           for t in transfers]
    assert got == want, (len(got), len(want))
    log(f"256 tx + 256 receipt values equal their encodings; "
        f"{len(got)} ERC20 transfers equal the fixture's logs "
        f"({time.time() - t0:.1f} s, compile included)")


def phase4_sweep(world, mesh=None):
    from zk_state_proofs_tpu.models import sweep_resident_epochs
    from zk_state_proofs_tpu.witness import pack_proofs

    trie, keys, _ = world
    root = trie.root_hash()
    proofs = [trie.get_proof(k) for k in keys]
    order = sorted(range(len(keys)), key=lambda i: -len(proofs[i]))
    gp = pack_proofs([(root, proofs[i], keys[i]) for i in order],
                     max_nodes=max(len(p) for p in proofs), node_len=576)
    t0 = time.time()
    res = sweep_resident_epochs(gp, epochs=16, batch=BATCH,
                                max_steps=gp.nodes.shape[1], salt=SEED % 97,
                                mesh=mesh)
    log(f"sweep_resident_epochs {len(keys)} accounts x 16 epochs"
        f"{'' if mesh is None else ' on %d devices' % mesh.devices.size}: "
        f"{res.total} proofs, found {res.found}, excluded {res.excluded}, "
        f"invalid {res.invalid} ({time.time() - t0:.1f} s, compile "
        f"included)")
    assert res.found == res.total == 16 * len(keys), res
    return gp, res


def phase5_keccak():
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import gpu_checks

    for summary in gpu_checks.check_keccak_kernel():
        log(f"keccak {summary}")
    log(f"pooled walk on the card vs oracle: {gpu_checks.check_walk_small()}")


def run_one_chip():
    world = account_world()
    with Phase("phase 1: serving"):
        phase1_serving(world)
    with Phase("phase 2: storage"):
        phase2_storage(storage_world())
    with Phase("phase 3: blocks"):
        phase3_blocks()
    with Phase("phase 4: resident sweep"):
        phase4_sweep(world)
    with Phase("phase 5: keccak kernel + gpu checks"):
        phase5_keccak()


def run_four_chips():
    """The sharded paths on a 4-device mesh, each against its one-device
    result bit for bit."""
    from zk_state_proofs_tpu.models import (verify_storage_grouped,
                                            sweep_resident_epochs)
    from zk_state_proofs_tpu.ops import mpt
    from zk_state_proofs_tpu.ops.trie_build import compute_root
    from zk_state_proofs_tpu.parallel import (compute_root_sharded,
                                              make_mesh,
                                              verify_proofs_sharded,
                                              verify_storage_grouped_sharded)
    from zk_state_proofs_tpu.witness import pack_proofs, synthetic_block
    from zk_state_proofs_tpu.witness.encoding import encode_receipt
    from zk_state_proofs_tpu.witness.trie_plan import plan_index_trie

    mesh = make_mesh(4)
    world = account_world()
    trie, keys, _ = world
    root = trie.root_hash()
    with Phase("4 chips: verify_proofs_sharded"):
        rng = np.random.default_rng(SEED)
        pick = rng.choice(len(keys), BATCH, replace=False)
        packed = pack_proofs([(root, trie.get_proof(keys[i]), keys[i])
                              for i in pick], max_nodes=12, node_len=576)
        one = [np.asarray(x) for x in mpt.verify_proofs_pooled(
            *packed.astuple(), *packed.pool())]
        st, vals, lens, counts = verify_proofs_sharded(mesh, packed)
        for a, b in zip(one, (st, vals, lens)):
            np.testing.assert_array_equal(a, b)
        assert int(counts[0]) == BATCH, counts
        log(f"{BATCH} proofs: status, values, lengths equal the one-device "
            f"result; psum counts {counts.tolist()}")
    with Phase("4 chips: verify_storage_grouped_sharded"):
        ap, sp, slots, owners, _, _ = storage_world()
        one = verify_storage_grouped(ap, sp, slots, owners)
        a_st, a_roots, s_st, s_v, s_vl, counts = \
            verify_storage_grouped_sharded(mesh, ap, sp, slots, owners)
        np.testing.assert_array_equal(one.account_status, a_st)
        np.testing.assert_array_equal(one.storage_root, a_roots)
        np.testing.assert_array_equal(one.slot_status, s_st)
        np.testing.assert_array_equal(one.slot_values, s_v)
        np.testing.assert_array_equal(one.slot_value_lens, s_vl)
        log(f"{sp.batch} slots of {ap.batch} accounts equal the one-device "
            f"result; psum counts {counts.tolist()}")
    with Phase("4 chips: compute_root_sharded"):
        fx = synthetic_block(num_txs=256, seed=SEED % 1000)
        plan = plan_index_trie([encode_receipt(r) for r in fx["receipts"]])
        r1, d1 = compute_root(plan)
        r4, d4 = compute_root_sharded(mesh, plan)
        np.testing.assert_array_equal(d1, d4)
        assert "0x" + bytes(r4).hex() == fx["block"]["receiptsRoot"]
        log(f"receipt-trie root and all {len(d4)} node digests equal the "
            f"one-device reduction and the block's receiptsRoot")
    with Phase("4 chips: sweep_resident_epochs(mesh=)"):
        gp, r1 = phase4_sweep(world)
        r4 = sweep_resident_epochs(gp, epochs=16, batch=BATCH,
                                   max_steps=gp.nodes.shape[1],
                                   salt=SEED % 97, mesh=mesh)
        assert (r4.total, r4.found, r4.excluded, r4.invalid) == (
            r1.total, r1.found, r1.excluded, r1.invalid), (r1, r4)
        log(f"4-device sweep counts equal the one-device sweep: "
            f"{r4.total} proofs, found {r4.found}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4 runs only the sharded paths on four cards")
    args = ap.parse_args(argv)
    t0 = time.time()
    phase0(args.chips)
    if args.chips == 4:
        run_four_chips()
    else:
        run_one_chip()
    import jax

    log(f"all phases ok in {time.time() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
