"""Large-scale verification sweeps — the 1M-proof workload (BASELINE #5).

Streams fixed-geometry witness batches through the (optionally mesh-
sharded) batch verifier, overlapping host packing with device compute via
async dispatch, and accumulates a throughput Meter. Batches reuse one jit
executable (stable bucket shapes), so the steady state is device time plus
host->device witness transfer.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import mpt
from ..utils.profiling import Meter
from ..witness.pack import PackedProofs


@dataclass
class SweepResult:
    total: int
    found: int
    excluded: int
    invalid: int
    seconds: float
    # streamed-sweep breakdown (sweep_entries): cumulative worker-thread
    # packing time (overlapped with device work), time blocked in dispatch,
    # and time draining the final results
    pack_seconds: float = 0.0
    dispatch_seconds: float = 0.0
    drain_seconds: float = 0.0
    batches: int = 0

    @property
    def proofs_per_sec(self) -> float:
        return self.total / max(self.seconds, 1e-9)


def sweep(batches, mesh=None, max_value_len: int = 128, max_steps=None,
          meter: Meter | None = None, dedup: bool = True) -> SweepResult:
    """Verify an iterable of PackedProofs (all with identical bucket
    geometry). With a mesh, each batch is dp-sharded across devices
    (batch sizes must divide the mesh). Returns aggregate counts + wall
    time (device-synced).

    dedup=True (the default, consistent with verify_merkle_batch /
    verify_proofs_sharded) hashes each batch's unique-node pool once —
    building the pool at pack time via packed.pool() if the packer didn't
    already; the sharded path replicates the pool across devices."""
    if mesh is not None:
        from ..parallel.mesh import make_sharded_verifier

        # memoized per (mesh, max_value_len, pooled) — no re-jit across calls
        fn = make_sharded_verifier(mesh, max_value_len=max_value_len,
                                   pooled=dedup)
    else:
        # mpt.verify_proofs[_pooled] is already jitted; calling it directly
        # reuses its global trace cache across sweep() invocations
        fn = functools.partial(
            mpt.verify_proofs_pooled if dedup else mpt.verify_proofs,
            max_value_len=max_value_len, max_steps=max_steps,
        )
    totals = np.zeros(3, dtype=np.int64)
    total = 0
    t0 = time.time()
    pending = []
    for packed in batches:
        pool = packed.pool() if dedup else ()
        if mesh is not None:
            active = np.ones(packed.batch, dtype=np.int32)
            out = fn(*(packed.astuple() + (active,) + pool))
            pending.append((packed.batch, out[3]))  # psum'ed counts
        else:
            status, _, _ = fn(*packed.astuple(), *pool)
            pending.append((packed.batch, status))
        total += packed.batch
    # drain
    for batch, out in pending:
        arr = np.asarray(out)
        if arr.shape == (3,):
            totals += arr.astype(np.int64)
        else:
            totals[0] += int((arr == mpt.FOUND).sum())
            totals[1] += int((arr == mpt.EXCLUDED).sum())
            totals[2] += int((arr == mpt.INVALID).sum())
    dt = time.time() - t0
    if meter is not None:
        meter.record(total, 0, 0, dt)
    return SweepResult(
        total=total, found=int(totals[0]), excluded=int(totals[1]),
        invalid=int(totals[2]), seconds=dt,
    )


def replicated_batches(packed: PackedProofs, n: int):
    """Yield the same packed batch n times (synthetic sweep driver)."""
    for _ in range(n):
        yield packed


# share of the device's memory limit that sweep_resident's materialized
# per-proof tables may take by default (the pool, its digests and the
# walk's working set live beside them)
MATERIALIZE_SHARE = 0.25


def fits_device_memory(nbytes: int, device=None) -> bool:
    """Whether `nbytes` fits in MATERIALIZE_SHARE of the device's memory
    limit (`memory_stats()["bytes_limit"]`). Raises when the device
    reports no limit (the CPU backend does not): pass materialize=
    explicitly there."""
    device = jax.devices()[0] if device is None else device
    stats = device.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(
            f"{device.platform} device reports no memory limit; pass "
            f"materialize=True or False explicitly")
    return nbytes <= MATERIALIZE_SHARE * stats["bytes_limit"]


def _counts_of(status):
    return jnp.stack([
        (status == mpt.FOUND).sum(),
        (status == mpt.EXCLUDED).sum(),
        (status == mpt.INVALID).sum(),
    ]).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("a", "dd", "n_len"))
def _expand_tables(pool, plens, dig, idx, *, a, dd, n_len):
    """Materialize global per-proof tables from the unique-node pool
    (one-time; the digests gathered here come from hashing the exact
    same pool rows the node bytes are gathered from). Tables are 2-D
    ([A, D*N] / [A, D*32]): one contiguous row per proof, so a batch is a
    contiguous row window."""
    flat = idx.reshape(-1)
    return (jnp.take(pool, flat, axis=0).reshape(a, dd * n_len),
            jnp.take(plens, flat).reshape(a, dd),
            jnp.take(dig, flat, axis=0).reshape(a, dd * 32))


def _verify_sel(sel, resident, max_value_len, max_steps, materialized):
    if materialized:
        nodes2, lens, digs2, num, roots, knib, klen = resident
        b = sel.shape[0]
        dd = lens.shape[1]
        status, _, _ = mpt.verify_proofs_prehashed(
            jnp.take(nodes2, sel, axis=0).reshape(b, dd, -1),
            jnp.take(lens, sel, axis=0),
            jnp.take(num, sel),
            jnp.take(digs2, sel, axis=0).reshape(b, dd, 32),
            jnp.take(roots, sel, axis=0),
            jnp.take(knib, sel, axis=0),
            jnp.take(klen, sel),
            max_value_len=max_value_len, max_steps=max_steps,
        )
    else:
        pool, plens, dig, idx, num, roots, knib, klen = resident
        status, _, _ = mpt.verify_proofs_indexed(
            pool, plens, dig,
            jnp.take(idx, sel, axis=0),
            jnp.take(num, sel),
            jnp.take(roots, sel, axis=0),
            jnp.take(knib, sel, axis=0),
            jnp.take(klen, sel),
            max_value_len=max_value_len, max_steps=max_steps,
        )
    return status


# module-level jitted drivers: a stable function identity keeps the jit
# trace cache warm across sweep_resident() calls (per-call closures would
# re-trace + re-load the executable inside the measured region)
@functools.partial(jax.jit, static_argnames=("max_value_len", "max_steps",
                                             "materialized"))
def _resident_step(acc, sel, *resident, max_value_len, max_steps,
                   materialized):
    return acc + _counts_of(_verify_sel(sel, resident, max_value_len,
                                        max_steps, materialized))


@functools.partial(jax.jit, static_argnames=("max_value_len", "max_steps",
                                             "materialized"))
def _resident_run(sel_all, *resident, max_value_len, max_steps,
                  materialized):
    def body(acc, sel):
        return acc + _counts_of(_verify_sel(sel, resident, max_value_len,
                                            max_steps, materialized)), None

    acc, _ = jax.lax.scan(body, jnp.zeros(3, jnp.int32), sel_all)
    return acc


def sweep_resident(global_packed: PackedProofs, index_batches,
                   max_value_len: int = 128, max_steps=None,
                   meter: Meter | None = None,
                   fused: bool = False,
                   materialize: bool | None = None) -> SweepResult:
    """Streaming sweep over a DEVICE-RESIDENT witness set.

    The global witness is packed and uploaded ONCE; each batch then ships
    only the proof row indices (i32 [B], ~16 KB) instead of ~23 MB of
    node tables per 4096-proof batch.

    materialize=True expands the pool ONCE into global per-proof tables
    (nodes [A, D, N], lens, digests) so each batch is a take of B
    contiguous proof rows + the prehashed walk
    (ops.mpt.verify_proofs_prehashed); materialize=False gathers pool
    rows per batch (ops.mpt.verify_proofs_indexed), the memory-lean form.
    The default (None) materializes when the tables fit in
    MATERIALIZE_SHARE of the device's memory limit. Hashing stays
    deduplicated either way: the pool is hashed exactly once and digests
    are gathered from it.

    fused=True runs the ENTIRE sweep as ONE device dispatch: all index
    batches are stacked to an i32 [nbatches, B] table, uploaded once, and
    a lax.scan walks the batches in-graph (per-batch table gathers +
    verifier + count accumulation all on device), so no per-dispatch
    overhead enters the sweep; requires every batch to have the same
    length.

    pack_seconds reports the one-time pool upload + hashing (+ global
    table materialization); dispatch_seconds the per-batch index
    streaming (or the single fused dispatch).
    """
    import jax
    import jax.numpy as jnp

    tp = time.time()
    pool_nodes, pool_lens, pool_idx = global_packed.pool()
    a, dd = pool_idx.shape
    n_len = pool_nodes.shape[1]
    if materialize is None:
        materialize = fits_device_memory(a * dd * (n_len + 4 + 32))
    d_pool = jax.device_put(pool_nodes)
    d_plens = jax.device_put(pool_lens.astype(np.int32))
    d_dig = mpt.hash_pool(d_pool, d_plens)
    d_idx = jax.device_put(pool_idx.astype(np.int32))
    d_num = jax.device_put(global_packed.num_nodes.astype(np.int32))
    d_roots = jax.device_put(global_packed.roots)
    d_knib = jax.device_put(global_packed.key_nibbles)
    d_klen = jax.device_put(global_packed.key_lens.astype(np.int32))

    if materialize:
        g_nodes, g_lens, g_digs = _expand_tables(d_pool, d_plens, d_dig,
                                                 d_idx, a=a, dd=dd,
                                                 n_len=n_len)
        jax.block_until_ready(g_digs)
        resident = (g_nodes, g_lens, g_digs, d_num, d_roots, d_knib, d_klen)
    else:
        jax.block_until_ready(d_dig)
        resident = (d_pool, d_plens, d_dig, d_idx, d_num, d_roots, d_knib,
                    d_klen)
    pack_s = time.time() - tp
    statics = dict(max_value_len=max_value_len, max_steps=max_steps,
                   materialized=materialize)

    if fused:
        sel_all = np.stack([np.asarray(s, dtype=np.int32)
                            for s in index_batches])  # [nb, B]
        nbatches, bsz = sel_all.shape
        t0 = time.time()
        d_sel = jax.device_put(sel_all)

        td = time.time()
        totals = np.asarray(
            _resident_run(d_sel, *resident, **statics)).astype(np.int64)
        dispatch_s = time.time() - td
        dt = time.time() - t0
        total = nbatches * bsz
        if meter is not None:
            meter.record(total, 0, 0, dt)
        return SweepResult(
            total=total, found=int(totals[0]), excluded=int(totals[1]),
            invalid=int(totals[2]), seconds=dt, pack_seconds=pack_s,
            dispatch_seconds=dispatch_s, drain_seconds=0.0, batches=nbatches,
        )

    total = 0
    nbatches = 0
    dispatch_s = 0.0
    acc = jnp.zeros(3, dtype=jnp.int32)
    t0 = time.time()
    for sel in index_batches:
        sel = jnp.asarray(np.asarray(sel, dtype=np.int32))
        td = time.time()
        acc = _resident_step(acc, sel, *resident, **statics)
        dispatch_s += time.time() - td
        total += sel.shape[0]
        nbatches += 1
    td = time.time()
    totals = np.asarray(acc).astype(np.int64)  # ONE device->host read
    drain_s = time.time() - td
    dt = time.time() - t0
    if meter is not None:
        meter.record(total, 0, 0, dt)
    return SweepResult(
        total=total, found=int(totals[0]), excluded=int(totals[1]),
        invalid=int(totals[2]), seconds=dt, pack_seconds=pack_s,
        dispatch_seconds=dispatch_s, drain_seconds=drain_s, batches=nbatches,
    )


@functools.partial(jax.jit, static_argnames=("epochs", "batch",
                                             "max_value_len", "max_steps"))
def _epoch_run(starts, ctr0, nodes2, lens, digs2, num, roots, knib, klen, *,
               epochs, batch, max_value_len, max_steps):
    dd = lens.shape[1]
    n_len = nodes2.shape[1] // dd

    def epoch_body(e, acc):
        ctr = (ctr0 + e).astype(jnp.uint8)

        def batch_body(acc, s0):
            nb = jax.lax.dynamic_slice(
                nodes2, (s0, 0), (batch, dd * n_len)).reshape(
                    batch, dd, n_len)
            # distinct work per epoch: the counter only touches PADDING
            # bytes, which the walk never reads
            nb = nb.at[:, :, -1].set(ctr)
            status, _, _ = mpt.verify_proofs_prehashed(
                nb,
                jax.lax.dynamic_slice(lens, (s0, 0), (batch, dd)),
                jax.lax.dynamic_slice(num, (s0,), (batch,)),
                jax.lax.dynamic_slice(
                    digs2, (s0, 0), (batch, dd * 32)).reshape(batch, dd, 32),
                jax.lax.dynamic_slice(roots, (s0, 0), (batch, 32)),
                jax.lax.dynamic_slice(knib, (s0, 0), (batch, knib.shape[1])),
                jax.lax.dynamic_slice(klen, (s0,), (batch,)),
                max_value_len=max_value_len, max_steps=max_steps,
            )
            return acc + _counts_of(status), None

        acc, _ = jax.lax.scan(batch_body, acc, starts)
        return acc

    # i32 accumulators: fine up to ~2.1B verified rows per call
    return jax.lax.fori_loop(0, epochs, epoch_body, jnp.zeros(3, jnp.int32))


@functools.lru_cache(maxsize=None)
def _make_sharded_epoch_run(mesh, epochs, batch_local, max_value_len,
                            max_steps):
    """dp-sharded wrapper of _epoch_run (memoized per (mesh, statics)):
    global tables row-sharded over the mesh, each device sweeps its own
    contiguous windows, per-device counts psum'ed — the BASELINE-config-5
    'sharded with collective reduction' shape."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]

    def fn(starts, ctr0, nodes2, lens, digs2, num, roots, knib, klen):
        local = _epoch_run(starts, ctr0, nodes2, lens, digs2, num, roots,
                           knib, klen, epochs=epochs, batch=batch_local,
                           max_value_len=max_value_len, max_steps=max_steps)
        return jax.lax.psum(local, axis)

    shard = P(axis)
    return jax.jit(shard_map(
        fn, mesh=mesh,
        in_specs=(P(), P(), shard, shard, shard, shard, shard, shard, shard),
        out_specs=P(), check_vma=False,
    ))


def sweep_resident_epochs(global_packed: PackedProofs, epochs: int,
                          batch: int, max_value_len: int = 128,
                          max_steps=None, salt: int = 0,
                          meter: Meter | None = None,
                          mesh=None) -> SweepResult:
    """Maximum-throughput resident sweep: `epochs` passes over the global
    witness set in contiguous `batch`-row windows, ONE device dispatch.

    The zero-gather formulation of the 1M-proof workload (BASELINE #5):
    global per-proof tables are materialized once from the unique-node
    pool (hashed once — dedup preserved), and every batch is a
    lax.dynamic_slice at a batch boundary, so the per-batch device work
    is the walk plus one contiguous copy — no row gathers at all.

    Every epoch's compute is DISTINCT work: an epoch counter (offset by
    `salt`) is written into each node's last padding byte in-graph, so
    XLA's loop-invariant hoisting cannot skip a batch (padding bytes are
    masked out of the walk, so statuses are unchanged — same
    device-carried perturbation bench.py uses). The global batch count is ceil(A/batch) per epoch
    with the tail window starting at A-batch (overlap rows re-verified;
    totals count every window row).

    With a `mesh` (1-D, n devices), the global tables are row-sharded
    over the mesh and each device sweeps its own A/n rows in batch/n
    windows (contiguous dynamic-slice windows per shard — the zero-gather
    property is preserved); per-device counts are psum'ed.
    Requires A % n == 0 and batch % n == 0. Window coverage per epoch is
    identical to dp=1 (each row verified once; tail overlap is per
    shard). This is BASELINE config 5's sharded shape.
    """
    import jax
    import jax.numpy as jnp

    tp = time.time()
    pool_nodes, pool_lens, pool_idx = global_packed.pool()
    a, dd = pool_idx.shape
    n_len = pool_nodes.shape[1]
    if batch > a:
        raise ValueError(f"batch {batch} exceeds global rows {a}")
    n_dev = 1
    if mesh is not None:
        n_dev = int(mesh.devices.size)
        if a % n_dev or batch % n_dev:
            raise ValueError(
                f"rows {a} and batch {batch} must divide the mesh ({n_dev})")
    d_pool = jax.device_put(pool_nodes)
    d_plens = jax.device_put(pool_lens.astype(np.int32))
    d_dig = mpt.hash_pool(d_pool, d_plens)
    d_idx = jax.device_put(pool_idx.astype(np.int32))
    d_num = jax.device_put(global_packed.num_nodes.astype(np.int32))
    d_roots = jax.device_put(global_packed.roots)
    d_knib = jax.device_put(global_packed.key_nibbles)
    d_klen = jax.device_put(global_packed.key_lens.astype(np.int32))

    g_nodes, g_lens, g_digs = _expand_tables(d_pool, d_plens, d_dig, d_idx,
                                             a=a, dd=dd, n_len=n_len)
    tables = (g_nodes, g_lens, g_digs, d_num, d_roots, d_knib, d_klen)
    if mesh is not None:
        # reshard the materialized tables row-wise over the mesh
        from jax.sharding import NamedSharding, PartitionSpec as P

        shard = NamedSharding(mesh, P(mesh.axis_names[0]))
        tables = tuple(jax.device_put(t, shard) for t in tables)
    jax.block_until_ready(tables[2])
    pack_s = time.time() - tp

    a_local = a // n_dev
    batch_local = batch // n_dev
    per_epoch = -(-a_local // batch_local)
    starts = np.minimum(np.arange(per_epoch) * batch_local,
                        a_local - batch_local).astype(np.int32)

    t0 = time.time()
    d_starts = jax.device_put(starts)
    ctr0 = jnp.asarray(np.int32(salt))
    if mesh is not None:
        run = _make_sharded_epoch_run(mesh, epochs, batch_local,
                                      max_value_len, max_steps)
        totals = np.asarray(run(d_starts, ctr0, *tables))
    else:
        totals = np.asarray(_epoch_run(
            d_starts, ctr0, *tables, epochs=epochs, batch=batch,
            max_value_len=max_value_len, max_steps=max_steps))
    dt = time.time() - t0
    total = int(epochs * per_epoch * batch)
    if meter is not None:
        meter.record(total, 0, 0, dt)
    return SweepResult(
        total=total, found=int(totals[0]), excluded=int(totals[1]),
        invalid=int(totals[2]), seconds=dt, pack_seconds=pack_s,
        dispatch_seconds=dt, drain_seconds=0.0,
        batches=epochs * per_epoch,
    )


def sweep_entries(entry_batches, max_nodes: int, node_len: int,
                  key_nibbles: int = 64, max_value_len: int = 128,
                  max_steps=None, dedup: bool = True, prefetch: int = 2,
                  pool_rows: int = 0, mesh=None,
                  meter: Meter | None = None) -> SweepResult:
    """END-TO-END streamed sweep: host packing INCLUDED in the measurement.

    `entry_batches` yields lists of (root, proof_nodes, key) — raw witness
    entries, not PackedProofs. A worker thread packs batch k+1..k+prefetch
    (native C++ packer + pooled dedup; ctypes releases the GIL, so packing
    genuinely overlaps device execution) while the device verifies batch k
    via async dispatch. This is the BASELINE config-5 pipeline: the number
    it produces is sustained proofs/s including witness packing and
    host->device transfer, not device time alone.

    Pass pool_rows (a fixed pool-row bucket) when dedup=True so every
    batch keeps one jit shape — a varying pool size would retrace and
    recompile the verifier per batch.
    """
    import concurrent.futures as cf

    from ..witness.pack import pack_proofs

    pack_time = [0.0]

    def pack_one(entries):
        t0 = time.time()
        packed = pack_proofs(entries, max_nodes=max_nodes, node_len=node_len,
                             key_nibbles=key_nibbles)
        if dedup:
            packed.pool(min_rows=pool_rows)
        pack_time[0] += time.time() - t0
        return packed

    if mesh is not None:
        from ..parallel.mesh import make_sharded_verifier

        sharded = make_sharded_verifier(mesh, max_value_len=max_value_len,
                                        pooled=dedup)

        def dispatch(packed):
            active = np.ones(packed.batch, dtype=np.int32)
            pool = packed.pool() if dedup else ()
            return packed.batch, sharded(*(packed.astuple() + (active,) + pool))[3]
    elif dedup:
        # pool-stream: per-batch host->device transfer is the unique-node
        # pool + row indices + per-proof scalars, never the [B, D, N]
        # node tables (~5x fewer bytes)
        fn = functools.partial(mpt.verify_proofs_pool_stream,
                               max_value_len=max_value_len,
                               max_steps=max_steps)

        def dispatch(packed):
            pn, pl, pi = packed.pool()
            return packed.batch, fn(pn, pl, pi, packed.num_nodes,
                                    packed.roots, packed.key_nibbles,
                                    packed.key_lens)[0]
    else:
        fn = functools.partial(mpt.verify_proofs,
                               max_value_len=max_value_len,
                               max_steps=max_steps)

        def dispatch(packed):
            return packed.batch, fn(*packed.astuple())[0]

    # Per-batch results are reduced to counts ON DEVICE and accumulated
    # into a device-resident [3] vector; the host reads it back ONCE after
    # the stream ends, so no per-batch device->host read serializes the
    # stream.
    import jax
    import jax.numpy as jnp

    @jax.jit
    def _acc(acc, status):
        return acc + jnp.stack([
            (status == mpt.FOUND).sum(),
            (status == mpt.EXCLUDED).sum(),
            (status == mpt.INVALID).sum(),
        ]).astype(jnp.int32)

    @jax.jit
    def _acc_counts(acc, counts):
        return acc + counts.astype(jnp.int32)

    total = 0
    nbatches = 0
    dispatch_s = 0.0
    acc = jnp.zeros(3, dtype=jnp.int32)

    t0 = time.time()
    with cf.ThreadPoolExecutor(max_workers=1) as pool_exec:
        it = iter(entry_batches)
        inflight = []
        for _ in range(prefetch):
            entries = next(it, None)
            if entries is None:
                break
            inflight.append(pool_exec.submit(pack_one, entries))
        while inflight:
            packed = inflight.pop(0).result()
            entries = next(it, None)
            if entries is not None:
                inflight.append(pool_exec.submit(pack_one, entries))
            td = time.time()
            _, out = dispatch(packed)  # async dispatch
            acc = _acc_counts(acc, out) if out.shape == (3,) else _acc(acc, out)
            dispatch_s += time.time() - td
            total += packed.batch
            nbatches += 1
    td = time.time()
    totals = np.asarray(acc).astype(np.int64)  # ONE device->host read
    drain_s = time.time() - td
    dt = time.time() - t0
    if meter is not None:
        meter.record(total, 0, 0, dt)
    return SweepResult(
        total=total, found=int(totals[0]), excluded=int(totals[1]),
        invalid=int(totals[2]), seconds=dt, pack_seconds=pack_time[0],
        dispatch_seconds=dispatch_s, drain_seconds=drain_s, batches=nbatches,
    )
