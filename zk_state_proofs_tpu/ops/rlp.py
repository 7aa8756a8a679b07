"""Fixed-shape, table-free RLP *node* decoding on device.

Device replacement for the RLP node codec the reference delegates to the
`eth_trie` crate and `alloy-rlp` (reference: crypto-ops/src/lib.rs:14-22,
trie-utils usage at proofs/transaction.rs:45,67). Everything operates on
zero-padded uint8 buffers with explicit lengths — static shapes under jit;
per-item spans come out of a 17-step lax.scan so branch (17-item) and
extension/leaf (2-item) nodes decode through one code path.

All functions are written for a SINGLE buffer and vmapped by callers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

MAX_ITEMS = 17  # branch node arity (16 children + value)


def _get(buf, idx):
    """Safe byte fetch as int32: clamps index into range (buffers carry zero
    padding, and all OOB reads happen only on already-invalid paths)."""
    idx = jnp.clip(idx, 0, buf.shape[0] - 1)
    return buf[idx].astype(jnp.int32)


def item_head(buf, pos):
    """Parse the RLP header of the item starting at byte offset `pos`.

    Returns (payload_start, payload_len, is_list, head_valid):
      - single byte < 0x80: payload is the byte itself (len 1)
      - 0x80-0xb7 short string / 0xc0-0xf7 short list: 1-byte header
      - 0xb8-0xbf long string / 0xf8-0xff long list: 1 + length-of-length
        header (lengths up to 3 bytes = 16 MB, far above any trie node)
    `head_valid` rejects length-of-length > 3 only; canonicality of the
    encoding itself is enforced by the trusted keccak commitment (a proof
    node hashes to its 32-byte identity, so byte-level malleability is
    already excluded).
    """
    b0 = _get(buf, pos)
    single = b0 < 0x80
    long_str = (b0 >= 0xB8) & (b0 <= 0xBF)
    long_list = b0 >= 0xF8
    is_list = b0 >= 0xC0
    lol = jnp.where(long_str, b0 - 0xB7, jnp.where(long_list, b0 - 0xF7, 0))
    l1, l2, l3 = _get(buf, pos + 1), _get(buf, pos + 2), _get(buf, pos + 3)
    long_len = jnp.where(
        lol == 1, l1, jnp.where(lol == 2, (l1 << 8) | l2, (l1 << 16) | (l2 << 8) | l3)
    )
    payload_len = jnp.where(
        single,
        1,
        jnp.where(
            long_str | long_list,
            long_len,
            jnp.where(is_list, b0 - 0xC0, b0 - 0x80),
        ),
    )
    payload_start = jnp.where(single, pos, pos + 1 + lol)
    head_valid = lol <= 3
    return payload_start, payload_len, is_list, head_valid


def node_items(buf, start, buf_len):
    """Decode a trie node (an RLP list) at `start` into up to 17 item spans.

    Returns a dict of arrays indexed [17]:
      item_start   header offset of each item (== inline-child node offset)
      payload_start, payload_len, is_list
      present      item exists (True for the node's real items)
    plus scalars: count (item count), list_end, well_formed.
    """
    ps, plen, is_list, head_ok = item_head(buf, start)
    end = ps + plen

    def step(cursor, _):
        ips, ipl, ilist, ok = item_head(buf, cursor)
        present = cursor < end
        item_end = ips + ipl
        nxt = jnp.where(present, item_end, cursor)
        return nxt, (cursor, ips, ipl, ilist, present, ok & present)

    cursor_final, (istart, ipay, iplen, ilist, present, iok) = jax.lax.scan(
        step, ps, None, length=MAX_ITEMS
    )
    count = present.sum()
    well_formed = (
        is_list
        & head_ok
        & (cursor_final == end)
        & (end <= buf_len)
        & jnp.all(~present | iok)
    )
    return {
        "item_start": istart,
        "payload_start": ipay,
        "payload_len": iplen,
        "is_list": ilist,
        "present": present,
        "count": count,
        "well_formed": well_formed,
        "list_end": end,
    }


def item_head_window(win):
    """item_head from pre-fetched byte windows starting at the item.

    win i32/u8 [..., >=4] (leading dims arbitrary — typically the proof
    batch). Returns (payload_offset, payload_len, is_list, head_valid), each
    [...], with payload_offset RELATIVE to the window start. All indexing is
    static — no gathers.
    """
    w = win.astype(jnp.int32)
    b0 = w[..., 0]
    single = b0 < 0x80
    long_str = (b0 >= 0xB8) & (b0 <= 0xBF)
    long_list = b0 >= 0xF8
    is_list = b0 >= 0xC0
    lol = jnp.where(long_str, b0 - 0xB7, jnp.where(long_list, b0 - 0xF7, 0))
    long_len = jnp.where(
        lol == 1, w[..., 1],
        jnp.where(lol == 2, (w[..., 1] << 8) | w[..., 2],
                  (w[..., 1] << 16) | (w[..., 2] << 8) | w[..., 3])
    )
    payload_len = jnp.where(
        single, 1,
        jnp.where(long_str | long_list, long_len,
                  jnp.where(is_list, b0 - 0xC0, b0 - 0x80)),
    )
    payload_off = jnp.where(single, 0, 1 + lol)
    return payload_off, payload_len, is_list, lol <= 3


def decode_node_select(table, start, buf_len, child_idx):
    """Decode a batch of trie nodes and select one child slot per node in a
    single unrolled pass — the walker's fast path.

    table f32 [B, NW, 4] (from `select.make_word_table`), start/buf_len/
    child_idx i32 [B]. Unlike `node_items` (lax.scan + stacked [17] arrays),
    this never materializes per-item arrays: the 17 header parses are
    unrolled straight-line (one packed-table contraction each — the minimum,
    since each item's offset depends on the previous header) and the slot at
    `child_idx` is accumulated with where-selects.

    Returns a dict of [B] arrays:
      count, well_formed, list_end
      i0_pay, i0_len, i0_list        (item 0 — hex-prefix path / branch c0)
      i1_start, i1_pay, i1_len, i1_list  (item 1 — ext/leaf payload)
      i16_pay, i16_len               (branch value slot)
      c_start, c_pay, c_len, c_list  (the slot at child_idx)
    """
    from .select import fetch_packed  # local import to avoid a cycle

    head_win = fetch_packed(table, start, 4)
    po, plen, is_list, head_ok = item_head_window(head_win)
    ps = start + po
    end = ps + plen
    zero = jnp.zeros_like(start)
    false = jnp.zeros(start.shape, jnp.bool_)
    sel = {
        "i0_pay": zero, "i0_len": zero, "i0_list": false,
        "i1_start": zero, "i1_pay": zero, "i1_len": zero, "i1_list": false,
        "i16_pay": zero, "i16_len": zero,
        "c_start": zero, "c_pay": zero, "c_len": zero, "c_list": false,
    }
    cursor = ps
    count = zero
    all_ok = jnp.ones(start.shape, jnp.bool_)
    for i in range(MAX_ITEMS):
        win = fetch_packed(table, cursor, 4)
        ipo, ipl, ilist, ok = item_head_window(win)
        ips = cursor + ipo
        present = cursor < end
        if i == 0:
            sel["i0_pay"], sel["i0_len"], sel["i0_list"] = ips, ipl, ilist
        if i == 1:
            sel["i1_start"], sel["i1_pay"], sel["i1_len"], sel["i1_list"] = (
                cursor, ips, ipl, ilist,
            )
        if i == 16:
            sel["i16_pay"], sel["i16_len"] = ips, ipl
        if i < 16:
            hit = present & (child_idx == i)
            sel["c_start"] = jnp.where(hit, cursor, sel["c_start"])
            sel["c_pay"] = jnp.where(hit, ips, sel["c_pay"])
            sel["c_len"] = jnp.where(hit, ipl, sel["c_len"])
            sel["c_list"] = jnp.where(hit, ilist, sel["c_list"])
        count = count + present.astype(jnp.int32)
        all_ok = all_ok & (~present | ok)
        cursor = jnp.where(present, ips + ipl, cursor)
    sel["count"] = count
    sel["list_end"] = end
    sel["well_formed"] = (
        is_list & head_ok & (cursor == end) & (end <= buf_len) & all_ok
    )
    return sel


def read_bytes32(buf, pos):
    """Gather 32 bytes starting at `pos` (clamped) as uint8 [32]."""
    idx = jnp.clip(pos + jnp.arange(32), 0, buf.shape[0] - 1)
    return buf[idx]


def bytes_to_nibbles_device(key_bytes):
    """[..., K] -> [..., 2K] nibble expansion (high first)."""
    hi = key_bytes >> 4
    lo = key_bytes & 0x0F
    return jnp.stack([hi, lo], axis=-1).reshape(*key_bytes.shape[:-1],
                                                key_bytes.shape[-1] * 2)
