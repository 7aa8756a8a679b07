"""L5 — multi-chip / multi-host sharded verification.

The reference has no parallelism at all (SURVEY.md §2.3: serial loop, one
proof at a time inside a zkVM). Here the proof batch is the parallel axis:
a 1-D `jax.sharding.Mesh` over the devices, batch dims sharded with
`shard_map`, per-shard verification via the batched device verifier, and
global stats (found/excluded/invalid counts) reduced with `psum` (NCCL on
GPUs). The mesh stays 1-D: the cards of a host reach each other all to all
over NVLink, so the layout follows the batch axis alone.

Across hosts the same code runs under `jax.distributed.initialize`
(parallel.multihost) with the batch sharded over every process's devices.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import mpt

BATCH_AXIS = "dp"


def make_mesh(n_devices: int | None = None, axis: str = BATCH_AXIS) -> Mesh:
    """1-D device mesh over the proof-batch axis."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def pad_batch(arrays, multiple: int):
    """Pad the leading batch dim of every array to a multiple (proofs with
    num_nodes == 0 and a non-empty root verify to INVALID and are sliced
    off by the caller)."""
    b = arrays[0].shape[0]
    bp = -(-b // multiple) * multiple
    if bp == b:
        return arrays, b
    out = []
    for a in arrays:
        pad = [(0, bp - b)] + [(0, 0)] * (a.ndim - 1)
        out.append(np.pad(np.asarray(a), pad))
    return tuple(out), b


@functools.lru_cache(maxsize=None)
def make_sharded_verifier(mesh: Mesh, max_value_len: int = 128,
                          pooled: bool = False):
    """Build a pjit-ted sharded batch verifier over `mesh`.

    Memoized on (mesh, max_value_len, pooled): repeated calls (sweeps,
    verify_proofs_sharded) reuse one jitted executable instead of
    re-tracing per invocation.

    Returns fn(nodes, node_lens, num_nodes, roots, key_nibbles, key_lens) ->
    (status [B], values [B, V], value_lens [B], global_counts [3]) with the
    batch axis sharded over the mesh and counts psum-reduced across shards.

    pooled=True appends (pool_nodes, pool_lens, pool_idx) inputs: the
    unique-node pool is REPLICATED across devices (proofs on every shard
    reference the same trie's nodes) while proofs stay batch-sharded —
    each device hashes the pool once instead of re-hashing its shard's
    node rows (see witness.pack.build_node_pool).
    """
    axis = mesh.axis_names[0]
    spec_b = P(axis)

    def _shard_fn(nodes, node_lens, num_nodes, roots, key_nibbles, key_lens,
                  active, *pool):
        if pooled:
            status, values, vlens = mpt.verify_proofs_pooled(
                nodes, node_lens, num_nodes, roots, key_nibbles, key_lens,
                *pool, max_value_len=max_value_len,
            )
        else:
            status, values, vlens = mpt.verify_proofs(
                nodes, node_lens, num_nodes, roots, key_nibbles, key_lens,
                max_value_len=max_value_len,
            )
        live = active > 0  # padding rows don't pollute the global stats
        local_counts = jnp.stack(
            [
                (live & (status == mpt.FOUND)).sum(),
                (live & (status == mpt.EXCLUDED)).sum(),
                (live & (status == mpt.INVALID)).sum(),
            ]
        )
        counts = jax.lax.psum(local_counts, axis)
        return status, values, vlens, counts

    in_specs = (spec_b,) * 7
    if pooled:
        in_specs += (P(), P(), spec_b)  # pool replicated, row->pool idx sharded
    sharded = shard_map(
        _shard_fn,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(spec_b, spec_b, spec_b, P()),
        check_vma=False,
    )
    return jax.jit(sharded)


@functools.lru_cache(maxsize=None)
def make_sharded_storage_verifier(mesh: Mesh):
    """dp-sharded GROUPED two-level storage verification over `mesh`
    (the reference's one-account/N-slots circuit shape,
    storage-circuit/src/main.rs:6-31, generalized to A accounts).

    Sharding layout: the SLOT batch is the parallel axis (it is the wide
    dimension — S slots per account); the A unique account proofs and
    both unique-node pools are REPLICATED, so every shard verifies the
    account level redundantly (A is small) and gathers its slots'
    trusted storage_roots locally — no cross-shard communication inside
    the step, one psum for the global slot counts. Results are
    bit-identical to models.verify_storage_grouped.
    """
    axis = mesh.axis_names[0]
    spec_b = P(axis)

    def _shard_fn(a_nodes, a_lens, a_num, a_roots, a_knib, a_klen,
                  a_pn, a_pl, a_pi,
                  s_nodes, s_lens, s_num, s_pn, s_pl, s_pi,
                  slots, slot_accounts, active):
        from ..models.verifier import _storage_core_grouped

        a_status, acct, s_status, s_values, s_vlens = _storage_core_grouped(
            a_nodes, a_lens, a_num, a_roots, a_knib, a_klen,
            a_pn, a_pl, a_pi,
            s_nodes, s_lens, s_num, s_pn, s_pl, s_pi,
            slots, slot_accounts)
        live = active > 0  # padded slot rows stay out of the global stats
        local_counts = jnp.stack([
            (live & (s_status == mpt.FOUND)).sum(),
            (live & (s_status == mpt.EXCLUDED)).sum(),
            (live & (s_status == mpt.INVALID)).sum(),
        ])
        counts = jax.lax.psum(local_counts, axis)
        return (a_status, acct["storage_root"], s_status, s_values,
                s_vlens, counts)

    in_specs = ((P(),) * 9            # account level + pool: replicated
                + (spec_b,) * 3       # slot proofs: sharded
                + (P(), P(), spec_b)  # slot pool replicated, idx sharded
                + (spec_b, spec_b, spec_b))  # slots, owners, active
    sharded = shard_map(
        _shard_fn,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(), P(), spec_b, spec_b, spec_b, P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def verify_storage_grouped_sharded(mesh: Mesh, account_packed,
                                   storage_packed, slots, slot_accounts):
    """Convenience wrapper over make_sharded_storage_verifier: pad the
    slot batch to the mesh size, shard, verify, slice back. Returns
    (account_status [A], storage_roots [A, 32], slot_status [B],
    slot_values [B, 64], slot_value_lens [B], global_counts [3])."""
    a, s = account_packed, storage_packed
    n = mesh.devices.size
    slots = np.asarray(slots, dtype=np.uint8)
    sa = np.asarray(slot_accounts, dtype=np.int32)
    active = np.ones(s.batch, dtype=np.int32)
    s_pool = s.pool()
    (s_nodes, s_lens, s_num, d_slots, d_sa, d_active, s_pi), b = pad_batch(
        (s.nodes, s.node_lens, s.num_nodes, slots, sa, active, s_pool[2]), n)
    fn = make_sharded_storage_verifier(mesh)
    a_st, a_roots, s_st, s_v, s_vl, counts = fn(
        *(a.astuple() + a.pool()),
        s_nodes, s_lens, s_num, s_pool[0], s_pool[1], s_pi,
        d_slots, d_sa, d_active)
    return (np.asarray(a_st), np.asarray(a_roots), np.asarray(s_st)[:b],
            np.asarray(s_v)[:b], np.asarray(s_vl)[:b], np.asarray(counts))


def verify_proofs_sharded(mesh: Mesh, packed, max_value_len: int = 128,
                          dedup: bool = True):
    """Convenience wrapper: pad the batch to the mesh size, shard, verify,
    slice back. `packed` is a witness.PackedProofs. dedup=True hashes the
    (replicated) unique-node pool once per device.

    Works on multi-process meshes too (after parallel.multihost.initialize):
    every process passes the same full packed batch; inputs are placed as
    global arrays (each process materializes only its addressable shards)
    and sharded outputs are allgathered back to every host."""
    import jax as _jax

    n = mesh.devices.size
    b = packed.batch
    multiproc = _jax.process_count() > 1
    active = np.ones(b, dtype=np.int32)
    axis = mesh.axis_names[0]
    if dedup:
        pool_nodes, pool_lens, pool_idx = packed.pool()
        arrays, b = pad_batch(packed.astuple() + (active, pool_idx), n)
        fn = make_sharded_verifier(mesh, max_value_len=max_value_len,
                                   pooled=True)
        args = arrays[:-1] + (pool_nodes, pool_lens, arrays[-1])
        specs = (P(axis),) * 7 + (P(), P(), P(axis))
    else:
        arrays, b = pad_batch(packed.astuple() + (active,), n)
        fn = make_sharded_verifier(mesh, max_value_len=max_value_len)
        args = arrays
        specs = (P(axis),) * 7
    if multiproc:
        from .multihost import put_global

        args = tuple(put_global(mesh, a, s) for a, s in zip(args, specs))
    status, values, vlens, counts = fn(*args)
    if multiproc:
        from .multihost import gather_to_host

        status, values, vlens = (gather_to_host(x)
                                 for x in (status, values, vlens))
    return (
        np.asarray(status)[:b],
        np.asarray(values)[:b],
        np.asarray(vlens)[:b],
        np.asarray(counts),
    )
