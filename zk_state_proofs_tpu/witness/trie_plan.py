"""Host-side trie planning for device-accelerated root computation.

The MPT's *structure* (node tree, every node's encoded length, where child
hashes sit inside parent encodings) is fully determined by the key/value
set — no hashing required. The planner builds that structure once on host
and emits per-level "templates": node encodings with 32-byte zero holes at
child-hash positions, plus (source-node, byte-offset) scatter plans.

The device then computes the root bottom-up (ops/trie_build.py): hash all
level-0 nodes with the batched keccak sponge, scatter the digests into the
level-1 templates, hash, and so on — a level-wise keccak reduction. This is
the device replacement for the reference's serial `trie.root_hash()` over
locally rebuilt tx/receipt tries (reference:
trie-utils/src/proofs/transaction.rs:41-66, proofs/receipt.rs:44-90).

Inline (<32-byte) nodes are spliced verbatim into their parents at plan
time; an inline node can never contain a hashed child (a 33-byte hash ref
would push it over 32 bytes), so inline subtrees are hole-free.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..oracle import rlp
from ..oracle.trie import EMPTY_ROOT, EthTrie, hp_encode
from ..oracle.trie import _BRANCH, _EXT, _LEAF  # node kinds


@dataclass
class LevelPlan:
    """One reduction level (all arrays numpy, device-put by the runner)."""

    templates: np.ndarray  # u8  [n, N_l] node encodings, zero holes
    lengths: np.ndarray    # i32 [n]
    node_ids: np.ndarray   # i32 [n]     global digest-slot ids
    hole_src: np.ndarray   # i32 [n, H]  global id of child digest (-1 = none)
    hole_off: np.ndarray   # i32 [n, H]  byte offset of the 32-byte hole


@dataclass
class TriePlan:
    levels: list            # LevelPlan, bottom (leaves) first
    root_id: int            # global id of the root node
    total_nodes: int
    root_is_empty: bool = False

    @property
    def num_levels(self) -> int:
        return len(self.levels)


def _template(node) -> tuple[bytes, list]:
    """Encoded bytes of `node` with zero-filled 32-byte holes for every
    hash-referenced child. Returns (bytes, [(child_node, hole_offset)]).
    Inline children are recursively spliced (hole-free by construction)."""
    if node.kind == _LEAF:
        return rlp.encode([hp_encode(node.path, True), node.value]), []

    def child_item(child):
        enc, holes = _template(child)
        if len(enc) >= 32:
            return b"\xa0" + b"\x00" * 32, [(child, 1)]  # 0xa0 ++ hash hole
        if holes:
            raise AssertionError("inline node cannot contain hashed children")
        return enc, []

    if node.kind == _EXT:
        child_enc, child_holes = child_item(node.child)
        prefix = rlp.encode(hp_encode(node.path, False))
        payload_len = len(prefix) + len(child_enc)
        header = _list_header(payload_len)
        holes = [(c, len(header) + len(prefix) + off) for c, off in child_holes]
        return header + prefix + child_enc, holes

    # branch
    parts, holes = [], []
    running = 0
    for child in node.children:
        if child is None:
            item = b"\x80"
            item_holes = []
        else:
            item, item_holes = child_item(child)
        parts.append(item)
        for c, off in item_holes:
            holes.append((c, running + off))
        running += len(item)
    value_item = rlp.encode(node.value if node.value is not None else b"")
    parts.append(value_item)
    running += len(value_item)
    header = _list_header(running)
    return header + b"".join(parts), [(c, len(header) + off) for c, off in holes]


def _list_header(payload_len: int) -> bytes:
    if payload_len < 56:
        return bytes([0xC0 + payload_len])
    lb = rlp.int_to_min_bytes(payload_len)
    return bytes([0xF7 + len(lb)]) + lb


def plan_trie(items) -> TriePlan:
    """Plan the level-wise reduction for the trie over `items` =
    [(key, value)]. The root and every hash-referenced node get a digest
    slot; levels order nodes so every child digest is ready before its
    parent hashes."""
    t = EthTrie()
    for k, v in items:
        t.insert(k, v)
    if t._root is None:
        return TriePlan(levels=[], root_id=-1, total_nodes=0, root_is_empty=True)

    # collect hashed nodes (root always hashed) + their templates & holes
    records = []  # (node, template_bytes, [(child, off)])
    seen = {}

    def visit(node) -> int:
        """Returns reduction level of this hashed node; registers it."""
        if id(node) in seen:
            return records[seen[id(node)]][3]
        enc, holes = _template(node)
        level = 0
        for child, _ in holes:
            level = max(level, visit(child) + 1)
        seen[id(node)] = len(records)
        records.append((node, enc, holes, level))
        return level

    root_level = visit(t._root)

    # assign global ids and group by level
    ids = {idx: gid for gid, idx in enumerate(range(len(records)))}
    node_gid = {id(rec[0]): gid for gid, rec in enumerate(records)}
    by_level = {}
    for gid, (node, enc, holes, level) in enumerate(records):
        by_level.setdefault(level, []).append(gid)

    levels = []
    for level in sorted(by_level):
        gids = by_level[level]
        n = len(gids)
        n_len = max(len(records[g][1]) for g in gids)
        h = max((len(records[g][2]) for g in gids), default=0)
        h = max(h, 1)
        templates = np.zeros((n, n_len), dtype=np.uint8)
        lengths = np.zeros(n, dtype=np.int32)
        node_ids = np.asarray(gids, dtype=np.int32)
        hole_src = np.full((n, h), -1, dtype=np.int32)
        hole_off = np.zeros((n, h), dtype=np.int32)
        for row, g in enumerate(gids):
            _, enc, holes, _ = records[g]
            templates[row, : len(enc)] = np.frombuffer(enc, dtype=np.uint8)
            lengths[row] = len(enc)
            for hi, (child, off) in enumerate(holes):
                hole_src[row, hi] = node_gid[id(child)]
                hole_off[row, hi] = off
        levels.append(
            LevelPlan(templates=templates, lengths=lengths, node_ids=node_ids,
                      hole_src=hole_src, hole_off=hole_off)
        )
    return TriePlan(levels=levels, root_id=node_gid[id(t._root)],
                    total_nodes=len(records))


def plan_index_trie(values) -> TriePlan:
    """Plan for a tx/receipt-style trie: key i = rlp(i)
    (reference transaction.rs:45)."""
    return plan_trie((rlp.encode_int(i), v) for i, v in enumerate(values))
