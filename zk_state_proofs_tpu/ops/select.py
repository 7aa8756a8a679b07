"""Gather-free dynamic fetches for the MPT walker.

These helpers fetch per-row dynamic byte windows with one-hot
contractions instead of gathers: two small batched contractions
(word-coarse select, then byte alignment) for wide windows, one
single-row contraction over a packed word table for the walker's 4-byte
RLP header reads. Whether plain gathers beat them on the GPU is not
measured yet.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def fetch_window(buf, pos, width: int):
    """buf u8 [B, N], pos i32 [B] -> u8 [B, width] where
    out[b, j] = buf[b, pos_b + j] (zero beyond N). Gather-free.

    Stage 1 selects width//4 + 1 aligned 4-byte words with a one-hot
    matmul over the word axis; stage 2 aligns to the byte offset with a
    second one-hot matmul. Exact in bf16: every product has a single
    non-zero term and bytes are < 2^8 < bf16's 2^9 integer range... bf16
    mantissa holds integers up to 256 exactly (0..255 all representable).
    """
    b, n = buf.shape
    if n % 4:
        buf = jnp.pad(buf, ((0, 0), (0, 4 - n % 4)))
        n = buf.shape[1]
    nw = n // 4
    pos = jnp.clip(pos, 0, n - 1)
    words = buf.reshape(b, nw, 4).astype(jnp.bfloat16)
    wpos = pos // 4
    k = (width + 3 + 3) // 4  # words covering width bytes at any pos%4
    kidx = jnp.arange(k)
    s1 = (
        jnp.arange(nw)[None, None, :] == (wpos[:, None, None] + kidx[None, :, None])
    ).astype(jnp.bfloat16)  # [B, K, NW]
    coarse = jax.lax.dot_general(
        s1, words, (((2,), (1,)), ((0,), (0,))), preferred_element_type=jnp.float32
    )  # [B, K, 4]
    flat = coarse.reshape(b, k * 4).astype(jnp.bfloat16)
    r = pos - 4 * wpos
    s2 = (
        jnp.arange(k * 4)[None, None, :]
        == (r[:, None, None] + jnp.arange(width)[None, :, None])
    ).astype(jnp.bfloat16)  # [B, width, K*4]
    out = jax.lax.dot_general(
        s2, flat, (((2,), (1,)), ((0,), (0,))), preferred_element_type=jnp.float32
    )  # [B, width]
    return out.astype(jnp.uint8)


def fetch_window_1d(buf, pos, width: int):
    """Single-example variant for use under vmap: buf u8 [N], pos scalar.
    Under an outer vmap the jnp ops batch transparently, so this lowers to
    the same batched-matmul form."""
    return fetch_window(buf[None], jnp.asarray(pos)[None], width)[0]


def make_word_table(buf):
    """Pack a byte buffer for `fetch_packed`: u8 [B, N] -> f32 [B, N//4, 4].

    Row w holds the u16 halves (hi16, lo16) of adjacent words w and w+1, so
    a SINGLE-row one-hot f32 contraction retrieves 8 consecutive bytes.
    Built once per walker step and reused by all 18 sequential header
    fetches of the RLP decode chain.

    The dot MUST run at Precision.HIGHEST: f32 matmuls may otherwise run
    in reduced precision (TF32 on NVIDIA tensor cores keeps 10 mantissa
    bits), which would corrupt the u16 halves (bytes, by contrast, are
    exact in bf16 — that's what fetch_window uses).
    """
    b, n = buf.shape
    if n % 4:
        buf = jnp.pad(buf, ((0, 0), (0, 4 - n % 4)))
        n = buf.shape[1]
    words = buf.reshape(b, n // 4, 4).astype(jnp.int32)
    hi = (words[..., 0] << 8) | words[..., 1]
    lo = (words[..., 2] << 8) | words[..., 3]
    nhi = jnp.concatenate([hi[:, 1:], jnp.zeros_like(hi[:, :1])], axis=1)
    nlo = jnp.concatenate([lo[:, 1:], jnp.zeros_like(lo[:, :1])], axis=1)
    return jnp.stack([hi, lo, nhi, nlo], axis=-1).astype(jnp.float32)


def fetch_packed(table, pos, width: int = 4):
    """Gather-free dynamic window fetch from a `make_word_table` buffer.

    table f32 [B, NW, 4], pos i32 [B], width <= 5 -> i32 [B, width] with
    out[b, j] = buf[b, pos_b + j] (0 beyond the buffer, pos clamped like
    `fetch_window`). One single-row one-hot f32 contraction (HIGHEST
    precision — exact for u16 halves) fetches the 8 bytes at the enclosing
    word pair; the residual (pos mod 4) alignment is a 4-way where-select
    over static slices, so widths up to 5 are always covered. For wider
    windows use `fetch_window`.
    """
    assert width <= 5, "fetch_packed covers <=5 bytes; use fetch_window"
    b, nw, _ = table.shape
    pos = jnp.clip(pos, 0, nw * 4 - 1)
    wpos = pos // 4
    onehot = (jnp.arange(nw)[None, :] == wpos[:, None]).astype(jnp.float32)
    halves = jax.lax.dot_general(
        onehot[:, None, :], table, (((2,), (1,)), ((0,), (0,))),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )[:, 0, :].astype(jnp.int32)  # [B, 4]
    b8 = jnp.stack([halves[:, 0] >> 8, halves[:, 0] & 255,
                    halves[:, 1] >> 8, halves[:, 1] & 255,
                    halves[:, 2] >> 8, halves[:, 2] & 255,
                    halves[:, 3] >> 8, halves[:, 3] & 255], axis=1)
    r = pos - 4 * wpos
    out = b8[:, 0:width]
    for s in (1, 2, 3):
        out = jnp.where((r == s)[:, None], b8[:, s:s + width], out)
    return out
