"""Batched Keccak-256 — the plain jnp sponge (the reference implementation
on every platform, the CPU path, and the parity oracle of ops.keccak_gpu).

Re-design of the reference's hashing hot loop
(reference: crypto-ops/src/keccak.rs:6-12 — tiny-keccak Keccak-f[1600],
serial, one message at a time). The state is 25 64-bit lanes held as hi/lo
uint32 pairs (no 64-bit integers needed, so it runs without jax_enable_x64)
with the lane axis LEADING and the message batch in the minor dims, so
every step is a short chain of elementwise/rolled ops over [25, *batch]
arrays vectorized across messages. The permutation is written in fully
*vectorized* form (theta/chi as rolls over the 5x5 grid, pi as a single
25-lane gather, rho as an elementwise variable-amount 64-bit rotate) — ~25
tensor ops per round, so the XLA graph stays small and compiles fast.

Ethereum's LEGACY Keccak padding (0x01) is used, not SHA-3's 0x06.

The sponge (`keccak256`) handles per-message variable length with a static
max length: messages are padded device-side and absorbed over a static block
count with per-message active masks — no dynamic shapes under jit.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..oracle.keccak import RATE, ROTATION_OFFSETS, ROUND_CONSTANTS

LANES = 25
WORDS_PER_BLOCK = RATE // 8  # 17 u64 lanes absorbed per rate block

# NOTE: module-level constants stay numpy so importing the package never
# initializes a JAX backend; jnp converts them at trace time.
_RC_LO = np.asarray([rc & 0xFFFFFFFF for rc in ROUND_CONSTANTS], dtype=np.uint32)
_RC_HI = np.asarray([rc >> 32 for rc in ROUND_CONSTANTS], dtype=np.uint32)

# pi step as a single gather: out[i] = in[_PI_SRC[i]]
_dest = np.zeros(25, dtype=np.int64)
for _x in range(5):
    for _y in range(5):
        _dest[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
_PI_SRC = np.asarray(_dest, dtype=np.int32)

_RHO = np.asarray(ROTATION_OFFSETS, dtype=np.uint32)
# post-pi rotation amounts: lane i is rotated by _RHO[_PI_SRC[i]]
_ROT = _RHO[_dest]
_ROT_SWAP = np.asarray(_ROT >= 32)  # 64-bit rotate >= 32: swap hi/lo first
_ROT_M = np.asarray(_ROT % 32, dtype=np.uint32)  # residual 0..31 rotate


def _rotl64_vec(hi, lo, swap, m):
    """Vectorized rotl64 by per-lane amounts. `swap` bool[25], `m` u32[25] in
    [0, 31]; hi/lo are [25, *batch]. Uses the ((x >> (31-m)) >> 1) form so a
    shift amount of 32 never occurs (XLA leaves it undefined)."""
    nd = hi.ndim
    shape = (25,) + (1,) * (nd - 1)
    swap = swap.reshape(shape)
    m = m.reshape(shape)
    h = jnp.where(swap, lo, hi)
    l = jnp.where(swap, hi, lo)
    inv = jnp.uint32(31) - m
    nh = (h << m) | ((l >> inv) >> 1)
    nl = (l << m) | ((h >> inv) >> 1)
    return nh, nl


def keccak_f1600(hi, lo, unroll: int = 2):
    """Keccak-f[1600] permutation, batched.

    hi, lo: uint32 arrays of shape [25, *batch] (lane axis first, x + 5*y
    order). Returns arrays of the same shape.
    """
    batch_nd = hi.ndim - 1
    grid = lambda a: a.reshape((5, 5) + a.shape[1:])  # [y, x, *batch]
    flat = lambda a: a.reshape((25,) + a.shape[2:])

    def round_fn(r, state):
        hi, lo = state
        gh, gl = grid(hi), grid(lo)
        # theta: column parities and their neighbor mix
        ch = jax.lax.reduce(gh, jnp.uint32(0), jax.lax.bitwise_xor, (0,))  # [5(x), *b]
        cl = jax.lax.reduce(gl, jnp.uint32(0), jax.lax.bitwise_xor, (0,))
        r1h = (ch << 1) | (cl >> 31)  # rotl64(c, 1)
        r1l = (cl << 1) | (ch >> 31)
        dh = jnp.roll(ch, 1, axis=0) ^ jnp.roll(r1h, -1, axis=0)
        dl = jnp.roll(cl, 1, axis=0) ^ jnp.roll(r1l, -1, axis=0)
        gh, gl = gh ^ dh[None], gl ^ dl[None]
        hi, lo = flat(gh), flat(gl)
        # pi (gather) then rho (vectorized 64-bit rotate by per-lane constants)
        hi, lo = hi[_PI_SRC], lo[_PI_SRC]
        hi, lo = _rotl64_vec(hi, lo, _ROT_SWAP, _ROT_M)
        # chi: b ^ (~b[x+1] & b[x+2]) along x
        gh, gl = grid(hi), grid(lo)
        gh = gh ^ (~jnp.roll(gh, -1, axis=1) & jnp.roll(gh, -2, axis=1))
        gl = gl ^ (~jnp.roll(gl, -1, axis=1) & jnp.roll(gl, -2, axis=1))
        hi, lo = flat(gh), flat(gl)
        # iota: xor round constant into lane 0
        rc_h = jnp.zeros((25,), jnp.uint32).at[0].set(jnp.asarray(_RC_HI)[r])
        rc_l = jnp.zeros((25,), jnp.uint32).at[0].set(jnp.asarray(_RC_LO)[r])
        shape = (25,) + (1,) * batch_nd
        return hi ^ rc_h.reshape(shape), lo ^ rc_l.reshape(shape)

    return jax.lax.fori_loop(0, 24, round_fn, (hi, lo), unroll=unroll)


def pad_messages(data, lengths, num_blocks: int):
    """Device-side Keccak pad10*1 (legacy 0x01 domain byte).

    data: uint8 [..., L], lengths: int32 [...]; returns uint8
    [..., num_blocks * RATE] with the 0x01 pad byte at position `length` and
    0x80 xored into the final byte of each message's last rate block.
    """
    padded_len = num_blocks * RATE
    pos = jnp.arange(padded_len, dtype=jnp.int32)
    L = data.shape[-1]
    if L < padded_len:
        data = jnp.pad(data, [(0, 0)] * (data.ndim - 1) + [(0, padded_len - L)])
    else:
        data = data[..., :padded_len]
    lengths = lengths[..., None]
    msg = jnp.where(pos < lengths, data, 0)
    msg = msg ^ (pos == lengths).astype(jnp.uint8) * jnp.uint8(0x01)
    last_byte = (lengths // RATE + 1) * RATE - 1
    msg = msg ^ (pos == last_byte).astype(jnp.uint8) * jnp.uint8(0x80)
    return msg


def bytes_to_lanes(block_bytes):
    """uint8 [..., RATE] -> (hi, lo) uint32 [..., 17], little-endian lanes."""
    b = block_bytes.reshape(block_bytes.shape[:-1] + (WORDS_PER_BLOCK, 8)).astype(
        jnp.uint32
    )
    lo = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    hi = b[..., 4] | (b[..., 5] << 8) | (b[..., 6] << 16) | (b[..., 7] << 24)
    return hi, lo


def lanes_to_bytes(hi, lo):
    """(hi, lo) uint32 [..., n] -> uint8 [..., 8n], little-endian."""
    words = jnp.stack([lo, hi], axis=-1)  # [..., n, 2]
    shifts = jnp.asarray([0, 8, 16, 24], dtype=jnp.uint32)
    by = (words[..., None] >> shifts) & jnp.uint32(0xFF)  # [..., n, 2, 4]
    return by.astype(jnp.uint8).reshape(hi.shape[:-1] + (hi.shape[-1] * 8,))


def _batch_to_front(a):
    """[..., 25] -> [25, ...] (lane axis leading for the permutation)."""
    return jnp.moveaxis(a, -1, 0)


def keccak256(data, lengths=None):
    """Batched Ethereum Keccak-256.

    data: uint8 [..., L]; lengths: int32 [...] (defaults to full L).
    Returns uint8 [..., 32]. Static block count = L // RATE + 1; messages
    shorter than L absorb fewer blocks via per-message masks.
    """
    data = jnp.asarray(data, dtype=jnp.uint8)
    if lengths is None:
        lengths = jnp.full(data.shape[:-1], data.shape[-1], dtype=jnp.int32)
    else:
        lengths = jnp.asarray(lengths, dtype=jnp.int32)
    num_blocks = data.shape[-1] // RATE + 1
    padded = pad_messages(data, lengths, num_blocks)
    blocks = padded.reshape(padded.shape[:-1] + (num_blocks, RATE))
    nblocks = lengths // RATE + 1  # [...]

    batch_shape = data.shape[:-1]
    hi = jnp.zeros((LANES,) + batch_shape, dtype=jnp.uint32)
    lo = jnp.zeros((LANES,) + batch_shape, dtype=jnp.uint32)

    def absorb(i, state):
        hi, lo = state
        bh, bl = bytes_to_lanes(blocks[..., i, :])  # [..., 17]
        bh, bl = _batch_to_front(bh), _batch_to_front(bl)  # [17, ...]
        pad_width = [(0, LANES - WORDS_PER_BLOCK)] + [(0, 0)] * len(batch_shape)
        nh, nl = keccak_f1600(hi ^ jnp.pad(bh, pad_width), lo ^ jnp.pad(bl, pad_width))
        active = (i < nblocks)[None]
        return jnp.where(active, nh, hi), jnp.where(active, nl, lo)

    if num_blocks == 1:
        hi, lo = absorb(0, (hi, lo))
    else:
        hi, lo = jax.lax.fori_loop(0, num_blocks, absorb, (hi, lo))
    out_hi = jnp.moveaxis(hi[:4], 0, -1)  # [..., 4]
    out_lo = jnp.moveaxis(lo[:4], 0, -1)
    return lanes_to_bytes(out_hi, out_lo)


def keccak256_fixed(data):
    """Keccak-256 of fixed-length messages (no length masking) — the fast
    path for trie-node hashing where the batch is bucketed by size."""
    return keccak256(data)
