"""Device-side trie root computation — level-wise keccak reduction.

Executes a host-built TriePlan (witness/trie_plan.py): per level, child
digests are gathered from the global digest buffer, scattered into the
zero-holed node templates, and the whole level is hashed by the batched
keccak kernel. Leaf levels are wide (one node per ~16 values), upper levels
shrink geometrically — so virtually all hashing happens in the first one or
two batched kernel calls.

Batched replacement for the reference's serial `EthTrie::root_hash`
(reference: trie-utils/src/proofs/transaction.rs:66 hot loop #2).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..oracle.trie import EMPTY_ROOT
from .backend import keccak256


def compute_root(plan):
    """Run the reduction; returns (root_digest: np.ndarray u8[32],
    all_digests: u8[total_nodes, 32])."""
    if plan.root_is_empty:
        return np.frombuffer(EMPTY_ROOT, dtype=np.uint8).copy(), np.zeros((0, 32), np.uint8)
    digests = jnp.zeros((plan.total_nodes, 32), dtype=jnp.uint8)
    for lvl in plan.levels:
        templ = jnp.asarray(lvl.templates)
        n, h = lvl.hole_src.shape
        if (lvl.hole_src >= 0).any():
            src = jnp.asarray(np.maximum(lvl.hole_src, 0))
            valid = jnp.asarray(lvl.hole_src >= 0)
            child = jnp.where(valid[..., None], digests[src], 0)  # [n, H, 32]
            rows = jnp.arange(n)[:, None, None]
            cols = jnp.asarray(lvl.hole_off)[:, :, None] + jnp.arange(32)[None, None, :]
            # holes are zero-initialized and disjoint -> scatter-add
            templ = templ.at[rows, cols].add(child.astype(jnp.uint8))
        dg = keccak256(templ, jnp.asarray(lvl.lengths))
        digests = digests.at[jnp.asarray(lvl.node_ids)].set(dg)
    root = np.asarray(digests[plan.root_id])
    return root, np.asarray(digests)


def compute_root_bytes(plan) -> bytes:
    return bytes(compute_root(plan)[0])
