"""Distributed trie-root reduction — collective root recomputation.

The level-wise keccak reduction (ops/trie_build.py) distributed over a
device mesh: wide levels (leaves — virtually all the hashing work) are
sharded across devices with `shard_map`, their digests exchanged with
`all_gather`, and the geometrically-shrinking upper levels are
computed replicated (SURVEY.md §7.4: keep upper levels replicated so
collective latency doesn't dominate). This is the scale-out path for
witness generation over whole blocks / 1M-proof sweeps (BASELINE config #5).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..oracle.trie import EMPTY_ROOT
from ..ops.backend import keccak256

# shard a level across the mesh only when every device gets at least this
# many nodes — below that the collective latency beats the compute win
MIN_NODES_PER_DEVICE = 8


def _hash_level_sharded(mesh: Mesh, templates, lengths):
    """Hash one level's node templates with the batch sharded over the mesh;
    returns replicated digests [n, 32] (all_gather over the mesh axis)."""
    axis = mesh.axis_names[0]
    ndev = mesh.devices.size
    n = templates.shape[0]
    npad = -(-n // ndev) * ndev
    if npad != n:
        templates = np.pad(templates, ((0, npad - n), (0, 0)))
        lengths = np.pad(lengths, (0, npad - n))

    def shard_fn(t, l):
        local = keccak256(t, l)                      # [n/ndev, 32]
        return jax.lax.all_gather(local, axis, axis=0, tiled=True)

    fn = shard_map(
        shard_fn, mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=P(),
        check_vma=False,
    )
    if jax.process_count() > 1:
        # multi-process mesh: place inputs as global arrays (each process
        # fills only its addressable shards); the all_gather'ed output is
        # replicated, pull it back to host numpy for the level loop
        from .multihost import put_global

        out = jax.jit(fn)(put_global(mesh, templates, P(axis)),
                          put_global(mesh, lengths, P(axis)))
        return np.asarray(out)[:n]
    return jax.jit(fn)(jnp.asarray(templates), jnp.asarray(lengths))[:n]


def compute_root_sharded(mesh: Mesh, plan):
    """Distributed variant of ops.trie_build.compute_root: wide levels are
    hashed device-parallel with all_gather'ed digests; narrow levels run
    replicated. Returns (root u8[32], all_digests u8[total, 32])."""
    if plan.root_is_empty:
        return np.frombuffer(EMPTY_ROOT, dtype=np.uint8).copy(), np.zeros((0, 32), np.uint8)
    ndev = mesh.devices.size
    digests = jnp.zeros((plan.total_nodes, 32), dtype=jnp.uint8)
    for lvl in plan.levels:
        templ = jnp.asarray(lvl.templates)
        n, h = lvl.hole_src.shape
        if (lvl.hole_src >= 0).any():
            src = jnp.asarray(np.maximum(lvl.hole_src, 0))
            valid = jnp.asarray(lvl.hole_src >= 0)
            child = jnp.where(valid[..., None], digests[src], 0)
            rows = jnp.arange(n)[:, None, None]
            cols = jnp.asarray(lvl.hole_off)[:, :, None] + jnp.arange(32)[None, None, :]
            templ = templ.at[rows, cols].add(child.astype(jnp.uint8))
        if n >= ndev * MIN_NODES_PER_DEVICE:
            dg = _hash_level_sharded(mesh, np.asarray(templ), lvl.lengths)
        else:
            dg = keccak256(templ, jnp.asarray(lvl.lengths))
        digests = digests.at[jnp.asarray(lvl.node_ids)].set(dg)
    root = np.asarray(digests[plan.root_id])
    return root, np.asarray(digests)
