"""Batched MPT proof verification on device — the framework's core op.

Re-design of the reference's `verify_merkle_proof`
(reference: crypto-ops/src/lib.rs:8-23) and the `eth_trie` nibble-path walk
it delegates to. Instead of a recursive DB walk, verification is
*phase-split*:

  Phase 1 (hash): every proof node in the batch is keccak-hashed by the
  batched sponge in one shot (ops.backend picks the implementation).
  Phase 2 (decode/compare): a fixed-trip-count walker steps root -> leaf
  through each proof, locating each consumed child by digest match over the
  proof rows (the reference's hash-keyed DB semantics — node order never
  matters, crypto-ops/src/lib.rs:10-14), decoding branch/extension/leaf
  structure with the fixed-shape RLP decoder, and consuming key nibbles.

The walker is natively batched (no vmap): every per-step quantity is a [B]
vector, and all dynamic byte access goes through ONE packed-word table per
step (select.make_word_table), so each fetch is a single one-hot
contraction. The 17 sequential header parses per node are irreducible (RLP
items are length-prefixed chains) but cost one small contraction each.

The batched step is conditioned at two levels (scalar lax.cond, so skipped
work costs nothing at runtime): the extension/leaf hex-prefix machinery
only runs on steps where some live proof sits on a 2-item node (account
tries: 1 of ~6 steps), and a step where no proof is live at all is a no-op
(early batch completion under conservative max_steps).

Instead of panicking like the reference ("Failed to verify" /
"Key does not exist!", crypto-ops/src/lib.rs:14,22), the batch verifier
returns a per-proof STATUS code plus the extracted value span:
  FOUND    — key present, value extracted (reference: the Ok path)
  EXCLUDED — proof is consistent and proves absence (reference panics
             "Key does not exist!")
  INVALID  — hash mismatch / malformed node / truncated proof (reference
             panics "Invalid merkle proof" or "Failed to verify")

Everything is static-shape: proofs are padded to [max_nodes, node_len] and
walked for a fixed number of steps with masked state updates. Inline
(<32-byte, embedded) child nodes are walked in-place within the parent's
buffer — no host-side flattening, the device verifies exactly the bytes the
hash commitment covers.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..oracle.trie import EMPTY_ROOT
from . import backend
from .rlp import bytes_to_nibbles_device, decode_node_select
from .select import fetch_window, make_word_table

# status codes (per proof)
RUNNING = 0
FOUND = 1
EXCLUDED = 2
INVALID = 3

# INVALID reason codes (per proof; verify_proofs_diagnose) — the debugging
# surface matching the reference's distinct panic messages
# ("Invalid merkle proof" / "Failed to verify", crypto-ops/src/lib.rs:14,22)
R_NONE = 0           # proof not INVALID
R_MALFORMED = 1      # ill-formed RLP node / wrong item count / bad hex-prefix
R_BAD_CHILD_REF = 2  # hash child reference is not 32 bytes
R_HASH_MISMATCH = 3  # referenced digest matches no proof node
R_ROOT_MISSING = 4   # no proof node hashes to the trusted root
R_TRUNCATED = 5      # walk ran out of nodes/steps before a terminal
REASON_NAMES = {
    R_NONE: "ok",
    R_MALFORMED: "malformed-node",
    R_BAD_CHILD_REF: "bad-child-ref",
    R_HASH_MISMATCH: "hash-mismatch",
    R_ROOT_MISSING: "root-missing",
    R_TRUNCATED: "truncated",
}

_EMPTY_ROOT_NP = np.frombuffer(EMPTY_ROOT, dtype=np.uint8)


def _step_pair(buf, key_nibbles, key_lens, key_pos, p0s, p0l, p0list):
    """Extension/leaf machinery for the whole batch: hex-prefix decode +
    nibble-path comparison. Two wide window fetches (`fetch_window`: wide
    windows go through its two-stage form) — executed under a scalar cond
    when `conditional`,
    since only steps where some live proof sits on a 2-item node need it."""
    maxnib = key_nibbles.shape[1]
    path_window = fetch_window(buf, p0s, maxnib // 2 + 2).astype(jnp.int32)
    wnib = bytes_to_nibbles_device(path_window)
    b0 = path_window[:, 0]
    flag = b0 >> 4
    is_leaf = flag >= 2
    odd = flag & 1
    hp_ok = ~p0list & (p0l >= 1) & (flag <= 3) & ((odd == 1) | ((b0 & 0x0F) == 0))
    n_path = 2 * (p0l - 1) + odd
    # path nibble j lives at global nibble index j + (2 - odd); odd has only
    # two values, so select between two static slices instead of gathering
    path_nib = jnp.where((odd == 1)[:, None], wnib[:, 1:maxnib + 1],
                         wnib[:, 2:maxnib + 2])
    key_nib = fetch_window(key_nibbles, key_pos, maxnib).astype(jnp.int32)
    j = jnp.arange(maxnib)[None, :]
    within_key = key_pos + n_path <= key_lens
    match = jnp.all((j >= n_path[:, None]) | (path_nib == key_nib),
                    axis=1) & within_key
    return {
        "is_leaf": is_leaf,
        "hp_ok": hp_ok,
        "n_path": n_path,
        "match": match,
    }


def _pair_zeros(b):
    return {
        "is_leaf": jnp.zeros((b,), jnp.bool_),
        "hp_ok": jnp.ones((b,), jnp.bool_),
        "n_path": jnp.zeros((b,), jnp.int32),
        "match": jnp.zeros((b,), jnp.bool_),
    }


def _step_merge(buf, num_nodes, digests, key_lens, carry, items, pair):
    """Resolve the batch's transitions from decode + pair outputs."""
    node_idx, off, key_pos, status, vnode, vstart, vlen, reason = carry

    is_branch = items["count"] == 17
    is_pair = items["count"] == 2
    bad_node = ~items["well_formed"] | (~is_branch & ~is_pair)

    # ---- branch node ----
    key_exhausted = key_pos >= key_lens
    bval_len = items["i16_len"]
    branch_found = is_branch & key_exhausted & (bval_len > 0)
    branch_excl = is_branch & key_exhausted & (bval_len == 0)
    take_child = is_branch & ~key_exhausted
    child_empty = take_child & ~items["c_list"] & (items["c_len"] == 0)

    # ---- extension/leaf node ----
    is_leaf = pair["is_leaf"]
    n_path = pair["n_path"]
    nibbles_match = pair["match"]
    leaf_found = is_pair & is_leaf & nibbles_match & (key_pos + n_path == key_lens)
    leaf_excl = is_pair & is_leaf & ~leaf_found
    ext_bad = is_pair & ~is_leaf & (n_path == 0)  # empty extension path
    ext_excl = is_pair & ~is_leaf & ~nibbles_match
    ext_child = is_pair & ~is_leaf & nibbles_match & ~ext_bad
    bad_node = bad_node | (is_pair & ~pair["hp_ok"]) | ext_bad

    # ---- merge child reference (branch child or extension child) ----
    has_child = take_child & ~child_empty | ext_child
    cstart = jnp.where(take_child, items["c_start"], items["i1_start"])
    cpay = jnp.where(take_child, items["c_pay"], items["i1_pay"])
    cplen = jnp.where(take_child, items["c_len"], items["i1_len"])
    clist = jnp.where(take_child, items["c_list"], items["i1_list"])
    child_hash = has_child & ~clist & (cplen == 32)
    child_inline = has_child & clist
    child_bad = has_child & ~clist & (cplen != 32)

    # hash-referenced child: locate the node whose digest matches, matching
    # the reference's hash-keyed proof DB (order-independent)
    expected = fetch_window(buf, cpay, 32)  # u8 [B, 32]
    d = digests.shape[1]
    row_match = jnp.all(digests == expected[:, None, :], axis=2) & (
        jnp.arange(d)[None, :] < num_nodes[:, None]
    )
    have_next = jnp.any(row_match, axis=1)
    nxt = jnp.argmax(row_match, axis=1).astype(jnp.int32)
    hash_fail = child_hash & ~have_next

    # ---- resolve new state ----
    new_status = jnp.where(
        bad_node | child_bad | hash_fail,
        INVALID,
        jnp.where(
            branch_found | leaf_found,
            FOUND,
            jnp.where(branch_excl | child_empty | leaf_excl | ext_excl,
                      EXCLUDED, RUNNING),
        ),
    )
    found_now = new_status == FOUND
    new_vnode = jnp.where(found_now, node_idx, vnode)
    new_vstart = jnp.where(
        found_now, jnp.where(leaf_found, items["i1_pay"], items["i16_pay"]),
        vstart,
    )
    new_vlen = jnp.where(
        found_now, jnp.where(leaf_found, items["i1_len"], items["i16_len"]),
        vlen,
    )
    new_key_pos = jnp.where(take_child, key_pos + 1,
                            jnp.where(ext_child, key_pos + n_path, key_pos))
    new_node_idx = jnp.where(child_hash, nxt, node_idx)
    new_off = jnp.where(child_hash, 0, jnp.where(child_inline, cstart, off))
    # diagnosable INVALID reason: first failure class that applied
    new_reason = jnp.where(
        bad_node, R_MALFORMED,
        jnp.where(child_bad, R_BAD_CHILD_REF,
                  jnp.where(hash_fail, R_HASH_MISMATCH, reason)))

    live = status == RUNNING
    pick = lambda new, old: jnp.where(live, new, old)
    return (
        pick(new_node_idx, node_idx),
        pick(new_off, off),
        pick(new_key_pos, key_pos),
        pick(new_status, status),
        pick(new_vnode, vnode),
        pick(new_vstart, vstart),
        pick(new_vlen, vlen),
        pick(new_reason, reason),
    )


def _init_carry(num_nodes, digests, roots):
    """Batched init: find each proof's root node by digest (it may sit
    anywhere in the unordered proof list)."""
    b, d = digests.shape[0], digests.shape[1]
    empty_proof = num_nodes == 0
    root_is_empty = jnp.all(roots == jnp.asarray(_EMPTY_ROOT_NP)[None, :], axis=1)
    root_match = jnp.all(digests == roots[:, None, :], axis=2) & (
        jnp.arange(d)[None, :] < num_nodes[:, None]
    )
    root_ok = jnp.any(root_match, axis=1)
    root_idx = jnp.argmax(root_match, axis=1).astype(jnp.int32)
    status0 = jnp.where(
        empty_proof,
        jnp.where(root_is_empty, EXCLUDED, INVALID),
        jnp.where(root_ok, RUNNING, INVALID),
    ).astype(jnp.int32)
    reason0 = jnp.where(status0 == INVALID, R_ROOT_MISSING, R_NONE)
    zero = jnp.zeros((b,), jnp.int32)
    return (root_idx, zero, zero, status0, zero, zero, zero, reason0)


def _word_shift_window(words, start_col, out_cols: int):
    """Per-row dynamic window over the column axis via a binary shift
    cascade: out[b, j] = words[b, start_col_b + j] (0 past the end).
    log2(C) stages of static slices + row-selects — no gathers, no
    one-hot materialization, so it scales to wide windows (tx values)
    where a one-hot select matrix would be GBs. Stages run with
    DESCENDING shifts and truncate progressively."""
    b, c = words.shape
    nbits = max(1, (c - 1).bit_length())
    cur = words
    for bit in reversed(range(nbits)):
        s = 1 << bit
        need = min(c, out_cols + s - 1)
        base = cur[:, :need]
        avail = max(cur.shape[1] - s, 0)
        if avail <= 0:
            shifted = jnp.zeros((b, need), cur.dtype)
        elif avail >= need:
            shifted = cur[:, s:s + need]
        else:
            shifted = jnp.pad(cur[:, s:], ((0, 0), (0, need - avail)))
        take = ((start_col >> bit) & 1) == 1
        cur = jnp.where(take[:, None], shifted, base)
    if cur.shape[1] < out_cols:  # buffer narrower than the window
        cur = jnp.pad(cur, ((0, 0), (0, out_cols - cur.shape[1])))
    return cur[:, :out_cols]


def _extract_value(nodes, carry, max_value_len: int):
    """Slice each proof's value bytes out of its terminal node.

    Gather-free: masked-sum node-row select over the i32 word view (D
    terms), a word-granular shift-cascade window at vstart//4, then a
    static 4-way byte alignment — memory-sane at tx-size values (2 KB
    windows)."""
    node_idx, off, key_pos, status, vnode, vstart, vlen, reason = carry
    b, d, n = nodes.shape
    n4 = -(-n // 4) * 4
    if n4 != n:
        nodes = jnp.pad(nodes, ((0, 0), (0, 0), (0, n4 - n)))
    w = nodes.astype(jnp.int32).reshape(b, d, n4 // 4, 4)
    words = (w[..., 0] << 24) | (w[..., 1] << 16) | (w[..., 2] << 8) | w[..., 3]
    valw = jnp.zeros((b, n4 // 4), jnp.int32)
    for dd in range(d):
        valw = jnp.where((vnode == dd)[:, None], words[:, dd], valw)
    vc = jnp.clip(vstart, 0, n4 - 1)
    k = max_value_len // 4 + 2
    win = _word_shift_window(valw, vc >> 2, k)  # [B, K]
    by = jnp.stack([(win >> 24) & 255, (win >> 16) & 255,
                    (win >> 8) & 255, win & 255], axis=-1).reshape(b, 4 * k)
    r = vc & 3
    out = by[:, 0:max_value_len]
    for s in (1, 2, 3):
        out = jnp.where((r == s)[:, None], by[:, s:s + max_value_len], out)
    value = jnp.where(jnp.arange(max_value_len)[None, :] < vlen[:, None],
                      out, 0)
    vlen = jnp.where(status == FOUND, vlen, 0)
    return status, value.astype(jnp.uint8), vlen


def walk_batch(nodes, node_lens, num_nodes, digests, roots, key_nibbles,
               key_lens, max_value_len: int, max_steps: int | None = None,
               conditional: bool = True):
    """Batched walk over [B, D, N] proofs.

    conditional=True gates the pair-node machinery and whole steps behind
    scalar lax.cond (wins when max_steps is conservative or pair nodes are
    rare per step); conditional=False emits straight-line steps (wins
    slightly when max_steps is exact, e.g. account-trie buckets)."""
    b, d, n = nodes.shape
    if max_steps is None:
        max_steps = d + 6  # hashed depth + headroom for nested inline nodes

    carry = _init_carry(num_nodes, digests, roots)
    kn32 = key_nibbles.astype(jnp.int32)
    maxnib = key_nibbles.shape[1]

    def step_body(carry):
        node_idx, off, key_pos = carry[0], carry[1], carry[2]
        buf = jnp.take_along_axis(nodes, node_idx[:, None, None], axis=1)[:, 0]
        blen = jnp.take_along_axis(node_lens, node_idx[:, None], axis=1)[:, 0]
        table = make_word_table(buf)
        # next key nibble via masked sum (the full key window is only needed
        # on pair-node steps and is fetched there)
        c = jnp.sum(jnp.where(jnp.arange(maxnib)[None, :] == key_pos[:, None],
                              kn32, 0), axis=1)
        items = decode_node_select(table, off, blen, c)
        run_pair = lambda: _step_pair(buf, key_nibbles, key_lens, key_pos,
                                      items["i0_pay"], items["i0_len"],
                                      items["i0_list"])
        if conditional:
            live = carry[3] == RUNNING
            any_pair = jnp.any((items["count"] == 2) & live)
            pair = jax.lax.cond(any_pair, run_pair, lambda: _pair_zeros(b))
        else:
            pair = run_pair()
        return _step_merge(buf, num_nodes, digests, key_lens, carry,
                           items, pair)

    def step(_, carry):
        if not conditional:
            return step_body(carry)
        any_live = jnp.any(carry[3] == RUNNING)
        return jax.lax.cond(any_live, step_body, lambda c: c, carry)

    carry = jax.lax.fori_loop(0, max_steps, step, carry)
    status, value, vlen = _extract_value(nodes, carry, max_value_len)
    reasons = jnp.where(status == RUNNING, R_TRUNCATED, carry[7])
    status = jnp.where(status == RUNNING, INVALID, status)
    return status, value, vlen, reasons


def walk_one(nodes, node_lens, num_nodes, digests, root, key_nibbles, key_len,
             max_value_len: int, max_steps: int | None = None):
    """Single-proof walk (thin wrapper over the batched walker)."""
    status, value, vlen, _ = walk_batch(
        nodes[None], node_lens[None], num_nodes[None], digests[None],
        root[None], key_nibbles[None], key_len[None], max_value_len, max_steps,
    )
    return status[0], value[0], vlen[0]


def hash_nodes(nodes, node_lens):
    """Phase 1: digest every padded proof node. nodes u8 [B, D, N],
    node_lens i32 [B, D] -> digests u8 [B, D, 32].

    Rows are hashed depth-major ([D, B] order): node size correlates
    strongly with trie depth (roots/branches span 4-5 rate blocks, leaves
    1, padding 0), so neighbouring rows share their block counts and the
    GPU sponge's per-program block loop stops early — a free transpose
    instead of a device sort."""
    b, d, n = nodes.shape
    flat = nodes.transpose(1, 0, 2).reshape(b * d, n)
    lens = node_lens.transpose(1, 0).reshape(b * d)
    digests = backend.keccak256(flat, lens)
    return digests.reshape(d, b, 32).transpose(1, 0, 2)


def _hash_pool_rows(pool_nodes, pool_lens, pool_segments=None):
    """Digest pool rows, optionally as one keccak call per contiguous
    block-count segment (PackedProofs.pool_block_segments()): each
    segment hashes at its own trimmed static width, so the mostly
    1-block leaves of the length-sorted pool do not carry the widest
    node's width through the sponge's input layout pass. Digests are
    bit-identical either way."""
    if pool_segments is None:
        return backend.keccak256(pool_nodes, pool_lens)
    outs, off = [], 0
    for cnt, w in pool_segments:
        outs.append(backend.keccak256(pool_nodes[off:off + cnt, :w],
                                      pool_lens[off:off + cnt]))
        off += cnt
    if off != pool_nodes.shape[0]:
        raise ValueError(
            f"pool_segments cover {off} rows, pool has {pool_nodes.shape[0]}")
    return jnp.concatenate(outs)


def scatter_pool_payload(payload, pool_idx):
    """Exact one-hot bf16 contraction: payload u8 [U, W], pool_idx i32
    [B, D] -> u8 [B, D, W]. Bytes are < 256, so every product and sum is
    exact in bf16 with f32 accumulation.

    Proof batches share trie nodes heavily (every proof repeats the trie's
    root/branch prefix), so the pool is hashed once (U << B*D rows) and
    its digests are scattered here. Security is unchanged: the walker
    still checks the keccak link of every step of every proof — equal
    per-proof bytes simply share one permutation, where the reference
    re-hashes per proof (crypto-ops/src/lib.rs:10-13)."""
    b, d = pool_idx.shape
    u = payload.shape[0]
    onehot = (
        jnp.arange(u, dtype=jnp.int32)[None, :] == pool_idx.reshape(b * d)[:, None]
    ).astype(jnp.bfloat16)
    return jax.lax.dot_general(
        onehot, payload.astype(jnp.bfloat16),
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    ).astype(jnp.uint8).reshape(b, d, -1)


@functools.partial(jax.jit,
                   static_argnames=("max_value_len", "max_steps",
                                    "conditional", "depth_segments",
                                    "pool_segments"))
def verify_proofs_pooled(nodes, node_lens, num_nodes, roots, key_nibbles,
                         key_lens, pool_nodes, pool_lens, pool_idx,
                         max_value_len: int = 128, max_steps: int | None = None,
                         conditional: bool = True,
                         depth_segments: tuple | None = None,
                         pool_segments: tuple | None = None):
    """`verify_proofs` with deduplicated hashing: the unique-node pool
    (PackedProofs.pool(): pool_nodes u8 [U, N], pool_lens i32 [U],
    pool_idx i32 [B, D]) is hashed once and its digests scattered to the
    per-proof table (scatter_pool_payload).

    depth_segments: static ((count, d), ...) covering the batch in order
    (PackedProofs.depth_segments()). The batch is walked as one walk per
    contiguous segment, with the node axis sliced to that segment's d and
    the digest scatter done per segment, so slots beyond a segment's d are
    neither scattered nor walked. Pool hashing stays shared;
    classification is unchanged (each proof still walks its own
    num_nodes; segment d >= every num_nodes inside it by construction,
    and max_steps defaults from the GLOBAL node axis).

    pool_segments: static ((row_count, width), ...) covering the pool in
    order (PackedProofs.pool_block_segments()) — pool hashing dispatches
    one keccak call per contiguous block-count segment at its trimmed
    width. Digests are bit-identical."""
    pool_dig = _hash_pool_rows(pool_nodes, pool_lens, pool_segments)
    if depth_segments is None:
        depth_segments = ((nodes.shape[0], nodes.shape[1]),)
    if max_steps is None:
        max_steps = nodes.shape[1] + 6  # global default, not per segment
    outs, off = [], 0
    for cnt, dseg in depth_segments:
        sl = slice(off, off + cnt)
        digests = scatter_pool_payload(pool_dig, pool_idx[sl, :dseg])
        outs.append(walk_batch(
            nodes[sl, :dseg], node_lens[sl, :dseg], num_nodes[sl], digests,
            roots[sl], key_nibbles[sl], key_lens[sl], max_value_len,
            max_steps, conditional)[:3])
        off += cnt
    if off != nodes.shape[0]:
        raise ValueError(
            f"depth_segments cover {off} rows, batch has {nodes.shape[0]}")
    if len(outs) == 1:
        return outs[0]
    return tuple(jnp.concatenate(parts) for parts in zip(*outs))


@jax.jit
def hash_pool(pool_nodes, pool_lens):
    """Digest a unique-node pool: u8 [U, N], i32 [U] -> u8 [U, 32].
    The one-time phase of the device-resident witness flow (see
    verify_proofs_indexed)."""
    return backend.keccak256(pool_nodes, pool_lens)


@functools.partial(jax.jit,
                   static_argnames=("max_value_len", "max_steps",
                                    "conditional"))
def verify_proofs_indexed(pool_nodes, pool_lens, pool_digests, pool_idx,
                          num_nodes, roots, key_nibbles, key_lens,
                          max_value_len: int = 128,
                          max_steps: int | None = None,
                          conditional: bool = True):
    """Verification against a DEVICE-RESIDENT witness pool.

    The streaming counterpart of verify_proofs_pooled for repeated sweeps
    over one trie: the unique-node pool (bytes + lengths + digests from
    hash_pool) stays on device across batches, and each batch ships only
    its row indices (~16 KB for 4096 proofs, against ~23 MB of per-proof
    node tables) — per-proof node tables are materialized on device by
    row gathers from the pool.

    Safety is unchanged from verify_proofs_pooled: nodes gathered from
    the pool are exactly the bytes the digests commit to (same row), and
    the walker still checks every per-proof hash link against `roots`
    (the reference re-hashes per proof, crypto-ops/src/lib.rs:10-13).

    pool_nodes u8 [U, N], pool_lens i32 [U], pool_digests u8 [U, 32],
    pool_idx i32 [B, D], num_nodes i32 [B], roots u8 [B, 32].
    """
    b, d = pool_idx.shape
    flat = pool_idx.reshape(b * d)
    nodes = jnp.take(pool_nodes, flat, axis=0).reshape(b, d, -1)
    node_lens = jnp.take(pool_lens, flat).reshape(b, d)
    digests = jnp.take(pool_digests, flat, axis=0).reshape(b, d, 32)
    return walk_batch(nodes, node_lens, num_nodes, digests, roots,
                      key_nibbles, key_lens, max_value_len, max_steps,
                      conditional)[:3]


@functools.partial(jax.jit,
                   static_argnames=("max_value_len", "max_steps", "conditional"))
def verify_proofs_prehashed(nodes, node_lens, num_nodes, digests, roots,
                            key_nibbles, key_lens,
                            max_value_len: int = 128,
                            max_steps: int | None = None,
                            conditional: bool = True):
    """The walk phase alone, against PRECOMPUTED node digests.

    For device-resident sweeps that materialize global per-proof tables
    once (models.sweep.sweep_resident with materialize=True): the pool is
    hashed a single time, digests are gathered into the global [A, D, 32]
    table, and each batch is a contiguous-row take of (nodes, lens,
    digests). Digests MUST come from hashing the same node bytes (the
    sweep materializes both from the same pool rows); the walker still
    checks every per-proof hash link against `roots` (the reference
    re-hashes per proof, crypto-ops/src/lib.rs:10-13)."""
    return walk_batch(nodes, node_lens, num_nodes, digests, roots,
                      key_nibbles, key_lens, max_value_len, max_steps,
                      conditional)[:3]


@functools.partial(jax.jit,
                   static_argnames=("max_value_len", "max_steps", "conditional"))
def verify_proofs_pool_stream(pool_nodes, pool_lens, pool_idx, num_nodes,
                              roots, key_nibbles, key_lens,
                              max_value_len: int = 128,
                              max_steps: int | None = None,
                              conditional: bool = True):
    """Pooled verification where ONLY the pool crosses the host->device
    link: the fresh-batch counterpart of verify_proofs_indexed.

    verify_proofs_pooled ships both the [B, D, N] per-proof node tables
    AND the pool; but the tables are fully determined by
    (pool_nodes, pool_idx), so a fresh streamed batch only needs the pool
    plus ~half a MB of per-proof scalars (a 4096-proof batch: ~4 MB of
    transfer instead of ~20 MB). Node bytes, digests, and gathers are
    materialized on device; every per-proof hash link is still checked by
    the walker (the reference re-hashes per proof,
    crypto-ops/src/lib.rs:10-13)."""
    digests = hash_pool(pool_nodes, pool_lens)
    return verify_proofs_indexed(pool_nodes, pool_lens, digests, pool_idx,
                                 num_nodes, roots, key_nibbles, key_lens,
                                 max_value_len=max_value_len,
                                 max_steps=max_steps, conditional=conditional)


@functools.partial(jax.jit,
                   static_argnames=("max_value_len", "max_steps", "conditional"))
def verify_proofs(nodes, node_lens, num_nodes, roots, key_nibbles, key_lens,
                  max_value_len: int = 128, max_steps: int | None = None,
                  conditional: bool = True):
    """Batched MPT proof verification.

    nodes       u8  [B, D, N]   zero-padded RLP proof nodes (any order)
    node_lens   i32 [B, D]
    num_nodes   i32 [B]
    roots       u8  [B, 32]     trusted root hashes
    key_nibbles u8  [B, K]      nibble-expanded lookup keys
    key_lens    i32 [B]         nibble counts
    max_steps: walker trip count; default D + 6 (depth + headroom for
    nested inline nodes). Tries whose values never encode below 32 bytes
    (account tries: leaves >= 70 B) cannot contain inline nodes, so
    max_steps = D is exact; with the any-live early-out the default is
    nearly as fast.
    Returns (status i32 [B], values u8 [B, max_value_len], value_lens i32 [B]).
    """
    digests = hash_nodes(nodes, node_lens)
    return walk_batch(nodes, node_lens, num_nodes, digests, roots,
                      key_nibbles, key_lens, max_value_len, max_steps,
                      conditional)[:3]


@functools.partial(jax.jit,
                   static_argnames=("max_value_len", "max_steps"))
def verify_proofs_diagnose(nodes, node_lens, num_nodes, roots, key_nibbles,
                           key_lens, max_value_len: int = 128,
                           max_steps: int | None = None):
    """`verify_proofs` plus a per-proof INVALID reason channel — the
    framework's debugging surface for the reference's distinct panic
    messages (crypto-ops/src/lib.rs:14,22).

    Returns (status i32 [B], values, value_lens, reasons i32 [B]) with
    reasons in {R_NONE, R_MALFORMED, R_BAD_CHILD_REF, R_HASH_MISMATCH,
    R_ROOT_MISSING, R_TRUNCATED} (names: REASON_NAMES)."""
    digests = hash_nodes(nodes, node_lens)
    return walk_batch(nodes, node_lens, num_nodes, digests, roots,
                      key_nibbles, key_lens, max_value_len, max_steps)
