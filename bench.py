"""Headline benchmark: batched MPT proof verification throughput per chip.

Prints ONE JSON line:
  {"metric": "mpt_proofs_per_sec_per_chip", "value": N, "unit": "proofs/s",
   ...}

The reference itself publishes no numbers (it verifies proofs serially
inside a zkVM).

The measured step is the full pipeline on real witnesses: batched keccak of
every unique proof node (ops.backend's sponge) + the batched MPT path walk
+ value extraction. Extra diagnostics (keccak-only throughput, batch
geometry) go to stderr. Runs on an NVIDIA GPU only; any other platform is
an error.
"""

import json
import sys
import time

import numpy as np


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def build_witness_batch(batch: int, n_accounts: int = 512,
                        max_nodes: int | None = None):
    """Real account-trie witnesses from an oracle-built trie.

    n_accounts == batch gives a DISTINCT-KEY batch (every proof a
    different account — the realistic headline shape); n_accounts < batch
    repeats keys batch/n_accounts times (the hot-trie shape: higher node
    dedup, reported as a secondary figure)."""
    from zk_state_proofs_tpu import native
    from zk_state_proofs_tpu.oracle import EthTrie, rlp
    from zk_state_proofs_tpu.witness import pack_proofs

    keccak256 = native.keccak256  # bit-identical to the oracle, ~1000x faster
    t = EthTrie(hasher=keccak256)
    keys = []
    for i in range(n_accounts):
        k = keccak256(b"bench-account-%d" % i)
        leaf = rlp.encode(
            [rlp.int_to_min_bytes(i), rlp.int_to_min_bytes(10**18 + i),
             keccak256(b"sroot%d" % i), keccak256(b"code%d" % i)]
        )
        t.insert(k, leaf)
        keys.append(k)
    root = t.root_hash()
    proofs = {k: t.get_proof(k) for k in keys}
    entries = [(root, proofs[keys[i % n_accounts]], keys[i % n_accounts])
               for i in range(batch)]
    # depth-sort the batch (descending): depth segments then walk at
    # their own depth instead of the batch max (4096 distinct accounts:
    # ~36% depth-4, ~57% depth-5, max 7) — a legitimate batch-formation
    # choice, like any depth-bucketing scheduler
    entries.sort(key=lambda e: -len(e[1]))
    # pack at the batch's natural depth (4096 distinct accounts -> 7,
    # 512-account hot trie -> 6) unless a bucket depth is given: the walk
    # costs one step per node row, so a shared conservative bucket would
    # slow the shallower shape
    return pack_proofs(entries, max_nodes=max_nodes, node_len=576)


def bench_verify(batch=4096, iters=20, n_accounts=None, label="distinct"):
    """Measure pooled verification throughput for one batch shape.

    n_accounts=None -> batch distinct accounts (the headline: realistic
    per-batch node dedup); n_accounts=512 -> the hot-trie secondary shape
    (8x repeated proofs, ~4x higher dedup). Returns (rate, dedup_ratio,
    packed) — packed so the keccak diagnostic can hash the REAL pool
    length mix the verifier sees."""
    import jax
    import jax.numpy as jnp
    from zk_state_proofs_tpu.ops import mpt

    if n_accounts is None:
        n_accounts = batch
    _log(f"backend: {jax.default_backend()}  devices: {jax.devices()}")
    t0 = time.time()
    packed = build_witness_batch(batch, n_accounts)
    pool = packed.pool()
    dedup_ratio = float(packed.num_nodes.sum()) / max(
        float((pool[1] > 0).sum()), 1.0)
    _log(f"[{label}] witness build: {time.time()-t0:.1f}s  "
         f"shapes nodes={packed.nodes.shape} pool={pool[0].shape} "
         f"({n_accounts} accounts, dedup {dedup_ratio:.1f}x)")

    args = [jnp.asarray(a) for a in packed.astuple()]
    pargs = [jnp.asarray(a) for a in pool]

    import functools
    # account-trie bucket: leaves are >= 70 B so inline nodes cannot occur;
    # the walk needs exactly max_nodes steps. Hashing is deduplicated over
    # the batch's unique-node pool (verify_proofs_pooled) — every hash link
    # is still checked per proof. The depth-sorted batch walks as
    # depth segments (each segment's static node axis sliced to its own
    # depth), and the length-sorted pool hashes as one keccak call per
    # block-count segment at its trimmed width.
    segs = packed.depth_segments()
    psegs = packed.pool_block_segments()
    _log(f"[{label}] depth segments: {segs}  pool segments: {psegs}")
    fn = functools.partial(mpt.verify_proofs_pooled, max_value_len=128,
                           max_steps=packed.nodes.shape[1], conditional=False,
                           depth_segments=segs, pool_segments=psegs)
    t0 = time.time()
    status, values, vlens = jax.block_until_ready(fn(*args, *pargs))
    _log(f"compile+first run: {time.time()-t0:.1f}s  "
         f"found={int((np.asarray(status)==mpt.FOUND).sum())}/{batch}")
    assert (np.asarray(status) == mpt.FOUND).all()

    # every measured iteration must be unique work (XLA hoists
    # loop-invariant computation): a device-carried counter is written into
    # the last padding byte of every node buffer — content (and thus every
    # keccak input) changes, results don't (bytes beyond node_lens are
    # masked out of both hashing and the walk). Iterations run IN-GRAPH
    # (fori_loop, chained through the counter and an accumulated status) so
    # the measurement is device throughput, not per-dispatch latency.
    K_INNER = 16

    @jax.jit
    def step(nodes, pool_nodes, ctr):
        def body(_, carry):
            ctr, acc, accv = carry
            ctr = ctr + 1
            perturbed = nodes.at[:, :, -1].set(ctr.astype(jnp.uint8))
            ppool = pool_nodes.at[:, -1].set(ctr.astype(jnp.uint8))
            s, v, l = fn(perturbed, *args[1:], ppool, *pargs[1:])
            # fold the extracted VALUES into a live accumulator: the
            # measured step must include value extraction (the reference's
            # verify RETURNS the value, crypto-ops/src/lib.rs:20-22) — an
            # unused `v` would be dead-code-eliminated by XLA and the
            # "full pipeline" rate would silently exclude extraction.
            # EVERY column is folded (sum over axis 1): a single-column
            # fold would let XLA slice-push-down prune the rest of the
            # byte-alignment cascade
            accv = accv ^ jnp.sum(v.astype(jnp.int32), axis=1) ^ (l << 8)
            return ctr, acc + s, accv
        ctr, acc, accv = jax.lax.fori_loop(
            0, K_INNER, body,
            (ctr, jnp.zeros((nodes.shape[0],), jnp.int32),
             jnp.zeros((nodes.shape[0],), jnp.int32)))
        return acc, accv, ctr

    # salt the counter start per process: a random ctr0 makes every run's
    # perturbation sequence unique while leaving results unchanged
    import secrets

    nodes, pool_nodes = args[0], pargs[0]
    salt = secrets.randbelow(1 << 20)
    _log(f"perturbation salt: {salt}")
    ctr0 = jnp.asarray(np.int32(salt))
    t0 = time.time()
    acc, accv, ctr = step(nodes, pool_nodes, ctr0)
    jax.block_until_ready((acc, accv))
    _log(f"iterated-step compile+1st: {time.time()-t0:.1f}s")
    assert (np.asarray(acc) == K_INNER * mpt.FOUND).all(), \
        "perturbed padding changed results"
    best = float("inf")
    for rep in range(3):
        t0 = time.time()
        out = None
        for _ in range(iters):
            out, outv, ctr = step(nodes, pool_nodes, ctr)
        np.asarray(out), np.asarray(outv)
        dt = (time.time() - t0) / (iters * K_INNER)
        best = min(best, dt)
        _log(f"[{label}] rep{rep}: {dt*1e3:.2f} ms/batch -> {batch/dt:,.0f} proofs/s")
    return batch / best, dedup_ratio, packed


def bench_resident_sweep(batch=4096, epochs=256):
    """Secondary figure: the 1M-proof device-resident epoch sweep
    (BASELINE config 5's zero-gather formulation) over the distinct-key
    witness set — ONE dispatch, each epoch distinct work via the in-graph
    padding counter, salted per process. Returns (proofs/s, shape label).

    NOTE the shape: a {batch}-account witness set re-swept for {epochs}
    epochs. bench_configs.py config 5 runs the LARGER 65,536-account x 16
    shape (and config 6 the 2^20 fully-distinct set); those rates are not
    interchangeable with this one — deeper witness sets walk more steps
    per proof. Every reported number carries its shape inline."""
    import secrets

    from zk_state_proofs_tpu.models import sweep_resident_epochs

    packed = build_witness_batch(batch, batch)
    d = packed.nodes.shape[1]
    sweep_resident_epochs(packed, epochs=epochs, batch=batch, max_steps=d,
                          salt=(1 << 20) + secrets.randbelow(1 << 10))
    res = sweep_resident_epochs(packed, epochs=epochs, batch=batch,
                                max_steps=d,
                                salt=secrets.randbelow(1 << 20))
    assert res.found == res.total, res
    shape = f"{batch} accounts x {epochs} epochs, depth {d}, one dispatch"
    _log(f"resident epoch sweep [{shape}]: {res.total:,} proofs in "
         f"{res.seconds:.3f}s -> {res.proofs_per_sec:,.0f} proofs/s "
         f"(pack+upload {res.pack_seconds:.2f}s)")
    return res.proofs_per_sec, shape


def bench_keccak_bucket(batch, length, iters=32):
    """One message-length bucket of the keccak diagnostic; returns
    (hashes/s, bytes/s)."""
    import jax
    import jax.numpy as jnp
    from zk_state_proofs_tpu.ops.backend import keccak256

    rng = np.random.default_rng(0)
    data = jnp.asarray(rng.integers(0, 256, (batch, length), dtype=np.uint8))

    K_INNER = 16

    @jax.jit
    def step(d, ctr):
        def body(_, carry):
            ctr, acc = carry
            ctr = ctr + 1
            out = keccak256(d.at[:, -1].set(ctr.astype(jnp.uint8)))
            return ctr, acc ^ out[:, 0].astype(jnp.int32)
        return jax.lax.fori_loop(
            0, K_INNER, body, (ctr, jnp.zeros((d.shape[0],), jnp.int32)))

    import secrets

    ctr = jnp.asarray(np.int32(secrets.randbelow(1 << 20)))
    ctr, acc = step(data, ctr)
    jax.block_until_ready(acc)
    best = float("inf")
    for _ in range(2):
        t0 = time.time()
        for _ in range(max(1, iters // K_INNER)):
            ctr, acc = step(data, ctr)
        jax.block_until_ready(acc)
        best = min(best, (time.time() - t0) / (max(1, iters // K_INNER) * K_INNER))
    return batch / best, batch * length / best


def bench_keccak_realmix(packed, iters=64):
    """Keccak diag on the REAL length mix the verifier hashes: the
    headline batch's length-sorted unique-node pool (pool_lens drive the
    sponge block counts exactly as in verify_proofs_pooled). The fixed
    buckets below bracket the range; this is the actual workload point.
    Perturbs byte 0 of every row (inside every real row's hashed span) so
    each iteration is distinct work."""
    import jax
    import jax.numpy as jnp
    from zk_state_proofs_tpu.ops.backend import keccak256

    pool_nodes, pool_lens, _ = packed.pool()
    data = jnp.asarray(pool_nodes)
    lens = jnp.asarray(pool_lens.astype(np.int32))
    real_rows = int((pool_lens > 0).sum())
    total_bytes = int(pool_lens.sum())
    blocks = int((pool_lens // 136 + 1).sum())

    K_INNER = 16

    @jax.jit
    def step(d, l, ctr):
        def body(_, carry):
            ctr, acc = carry
            ctr = ctr + 1
            out = keccak256(d.at[:, 0].set(ctr.astype(jnp.uint8)), l)
            return ctr, acc ^ out[:, 0].astype(jnp.int32)
        return jax.lax.fori_loop(
            0, K_INNER, body, (ctr, jnp.zeros((d.shape[0],), jnp.int32)))

    import secrets

    ctr = jnp.asarray(np.int32(secrets.randbelow(1 << 20)))
    ctr, acc = step(data, lens, ctr)
    jax.block_until_ready(acc)
    best = float("inf")
    for _ in range(2):
        t0 = time.time()
        for _ in range(max(1, iters // K_INNER)):
            ctr, acc = step(data, lens, ctr)
        jax.block_until_ready(acc)
        best = min(best, (time.time() - t0) / (max(1, iters // K_INNER) * K_INNER))
    rate = real_rows / best
    _log(f"keccak diag [REAL pool mix: {real_rows} rows of "
         f"{data.shape[0]} incl. padding, {total_bytes} B, {blocks} rate "
         f"blocks]: {rate/1e6:.1f} M hashes/s/chip "
         f"({total_bytes/best/1e9:.2f} GB/s)")
    return rate


def bench_keccak(batch=1 << 17):
    """Secondary diagnostic (stderr): Keccak-256 rate by rate-block count —
    BASELINE's first metric (target >= 10M single-block hashes/sec/chip).
    Trie nodes span 1-4 rate blocks (leaves ~1, 532 B branch nodes 4), so
    the multi-block buckets cover the actual hashing workload."""
    # lengths chosen per block count: blocks = len // 136 + 1 (legacy pad)
    buckets = [(100, 1), (200, 2), (350, 3), (532, 4)]
    single = None
    for length, blocks in buckets:
        rate, byte_rate = bench_keccak_bucket(batch, length)
        if blocks == 1:
            single = rate
        _log(f"keccak diag [{blocks} block{'s' if blocks > 1 else ''}, "
             f"{length} B]: {rate/1e6:.1f} M hashes/s/chip "
             f"({byte_rate/1e9:.2f} GB/s)")
    return single


def require_gpu():
    """The benchmark measures the GPU only: any other platform is an
    error, never a fallback."""
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench: no GPU (JAX platform {jax.default_backend()!r})")


def main():
    from zk_state_proofs_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    require_gpu()
    # HEADLINE: 4096 distinct accounts over a 4096-account trie — realistic
    # per-batch node dedup (~2.5x), no repeated proofs
    value, dedup, packed = bench_verify(label="distinct")
    extras = {"dedup_ratio": round(dedup, 2)}
    # secondary: the hot-trie shape (512 accounts, proofs repeated 8x,
    # ~4x higher dedup), reported as context
    hot, hot_dedup, _ = bench_verify(iters=10, n_accounts=512,
                                     label="hot-trie")
    extras["hot_trie_proofs_per_sec"] = round(hot, 1)
    extras["hot_trie_dedup_ratio"] = round(hot_dedup, 2)
    rate, shape = bench_resident_sweep()
    extras["resident_sweep_proofs_per_sec"] = round(rate, 1)
    extras["resident_sweep_shape"] = shape
    extras["keccak_real_mix_hashes_per_sec"] = round(
        bench_keccak_realmix(packed), 1)
    bench_keccak()
    print(json.dumps({
        "metric": "mpt_proofs_per_sec_per_chip",
        "value": round(value, 1),
        "unit": "proofs/s",
        **extras,
    }))


if __name__ == "__main__":
    main()
