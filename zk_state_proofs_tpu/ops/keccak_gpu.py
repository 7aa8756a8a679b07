"""Batched Keccak-256 as a Pallas kernel for NVIDIA GPUs (Triton route).

One message per lane: a program owns a power-of-two block of rows and
keeps each row's sponge state (25 64-bit lanes as hi/lo u32 pairs) in
registers for the whole message. A round is straight-line integer code
with static rotation amounts; the 24 rounds run as a loop that reads its
round constant from a 48-word table. The kernel reads the raw row words and applies Ethereum's
legacy pad10*1 (0x01 domain byte) itself by length, so no padded copy of
the input is made. A program loops over rate blocks up to the largest
block count among its own rows; rows that finished earlier keep their
state.

Input layout is word-major: the wrapper views the u8 [U, L] rows as
little-endian u32 words and transposes them to [L/4, U], so word w of a
block of rows is one contiguous, coalesced load. Keccak lane j of rate
block b is row words (34 b + 2 j, 34 b + 2 j + 1) as (lo, hi), since
136 % 8 == 0.

Replaces the reference's serial tiny-keccak loop
(reference: crypto-ops/src/keccak.rs:6-12).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..oracle.keccak import RATE, ROTATION_OFFSETS, ROUND_CONSTANTS

WORDS_PER_BLOCK = RATE // 4  # 34 u32 words absorbed per rate block
BLOCK_ROWS = 64              # rows (messages) per program; one per thread

# round constants as (hi, lo) u32 pairs: _RC[2 r], _RC[2 r + 1]
_RC = np.asarray([w for rc in ROUND_CONSTANTS
                  for w in (rc >> 32, rc & 0xFFFFFFFF)], dtype=np.uint32)

# pi destination: out[_PI_DEST[i]] = rot(in[i], ROTATION_OFFSETS[i])
_PI_DEST = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_DEST[_x + 5 * _y] = _y + 5 * ((2 * _x + 3 * _y) % 5)


def _rotl(hi, lo, n: int):
    """64-bit rotate-left by a static amount on (hi, lo) u32 vectors."""
    n %= 64
    if n == 0:
        return hi, lo
    if n == 32:
        return lo, hi
    if n > 32:
        hi, lo = lo, hi
        n -= 32
    return (hi << n) | (lo >> (32 - n)), (lo << n) | (hi >> (32 - n))


def _round(ah, al, rc_hi, rc_lo):
    """One Keccak-f[1600] round on 25 hi and 25 lo u32 vectors."""
    ah, al = list(ah), list(al)
    # theta
    ch = [ah[x] ^ ah[x + 5] ^ ah[x + 10] ^ ah[x + 15] ^ ah[x + 20]
          for x in range(5)]
    cl = [al[x] ^ al[x + 5] ^ al[x + 10] ^ al[x + 15] ^ al[x + 20]
          for x in range(5)]
    for x in range(5):
        rh, rl = _rotl(ch[(x + 1) % 5], cl[(x + 1) % 5], 1)
        dh = ch[(x - 1) % 5] ^ rh
        dl = cl[(x - 1) % 5] ^ rl
        for y in range(5):
            ah[x + 5 * y] = ah[x + 5 * y] ^ dh
            al[x + 5 * y] = al[x + 5 * y] ^ dl
    # rho + pi
    bh, bl = [None] * 25, [None] * 25
    for i in range(25):
        bh[_PI_DEST[i]], bl[_PI_DEST[i]] = _rotl(ah[i], al[i],
                                                 ROTATION_OFFSETS[i])
    # chi
    for y in range(5):
        rowh = bh[5 * y:5 * y + 5]
        rowl = bl[5 * y:5 * y + 5]
        for x in range(5):
            ah[x + 5 * y] = rowh[x] ^ (~rowh[(x + 1) % 5]
                                       & rowh[(x + 2) % 5])
            al[x + 5 * y] = rowl[x] ^ (~rowl[(x + 1) % 5]
                                       & rowl[(x + 2) % 5])
    # iota
    ah[0] = ah[0] ^ rc_hi
    al[0] = al[0] ^ rc_lo
    return tuple(ah), tuple(al)


def _sponge_kernel(rc_ref, lens_ref, words_ref, out_ref, *, n_rows: int,
                   n_words: int, block: int):
    rows = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
    live = rows < n_rows
    lens = plgpu.load(lens_ref.at[rows], mask=live, other=0)
    nblk = jnp.where(live, lens // RATE + 1, 0)
    zero = jnp.zeros((block,), jnp.uint32)

    def word(widx, q):
        """Message word at row-word `widx` (bytes q..q+3): raw bytes masked
        to the row's length, the 0x01 pad byte at offset `len`."""
        raw = plgpu.load(words_ref.at[widx * n_rows + rows],
                         mask=live & (widx < n_words), other=0)
        nb = lens - q  # bytes of this word inside the message
        sh = (jnp.clip(nb, 0, 3) * 8).astype(jnp.uint32)
        keep = jnp.where(nb >= 4, jnp.uint32(0xFFFFFFFF),
                         jnp.where(nb <= 0, jnp.uint32(0),
                                   (jnp.uint32(1) << sh) - jnp.uint32(1)))
        pad = jnp.where((nb >= 0) & (nb < 4), jnp.uint32(1) << sh,
                        jnp.uint32(0))
        return (raw & keep) ^ pad

    def absorb(ib, state):
        sh, sl = state
        xh, xl = list(sh), list(sl)
        for j in range(RATE // 8):
            base = ib * WORDS_PER_BLOCK + 2 * j
            q = ib * RATE + 8 * j
            xl[j] = sl[j] ^ word(base, q)
            hw = word(base + 1, q + 4)
            if j == RATE // 8 - 1:  # 0x80 closes the last rate block
                hw = hw ^ jnp.where(ib == nblk - 1, jnp.uint32(0x80000000),
                                    jnp.uint32(0))
            xh[j] = sh[j] ^ hw
        nh, nl = jax.lax.fori_loop(
            0, len(ROUND_CONSTANTS),
            lambda r, st: _round(*st, plgpu.load(rc_ref.at[2 * r]),
                                 plgpu.load(rc_ref.at[2 * r + 1])),
            (tuple(xh), tuple(xl)))
        active = ib < nblk
        return (tuple(jnp.where(active, a, b) for a, b in zip(nh, sh)),
                tuple(jnp.where(active, a, b) for a, b in zip(nl, sl)))

    sh, sl = jax.lax.fori_loop(0, jnp.max(nblk), absorb,
                               ((zero,) * 25, (zero,) * 25))
    for j in range(4):  # digest = lanes 0..3, little-endian (lo, hi) words
        plgpu.store(out_ref.at[(2 * j) * n_rows + rows], sl[j], mask=live)
        plgpu.store(out_ref.at[(2 * j + 1) * n_rows + rows], sh[j],
                    mask=live)


@functools.partial(jax.jit, static_argnames=("block", "call_options"))
def _sponge(data, lens, *, block: int, call_options: tuple):
    """data u8 [U, L] (L % 4 == 0), lens i32 [U] -> u8 [U, 32]."""
    u, width = data.shape
    n_words = width // 4
    if n_words * u >= 1 << 31:
        raise ValueError(f"{u} rows of {width} B exceed the kernel's i32 index")
    words = jax.lax.bitcast_convert_type(data.reshape(u, n_words, 4),
                                         jnp.uint32)  # little-endian view
    kernel = functools.partial(_sponge_kernel, n_rows=u, n_words=n_words,
                               block=block)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((8 * u,), jnp.uint32),
        grid=(pl.cdiv(u, block),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=max(block // 32, 1),
                                             num_stages=1),
        name="keccak256_sponge",
        **dict(call_options),
    )(jnp.asarray(_RC), lens, words.T.reshape(-1))
    return jax.lax.bitcast_convert_type(out.reshape(8, u).T, jnp.uint8)


def keccak256_gpu(data, lengths=None, *, block: int = BLOCK_ROWS,
                  **call_options):
    """Batched Ethereum Keccak-256 on the GPU kernel.

    data: uint8 [..., L]; lengths: int32 [...] (defaults to full L; each
    must be <= L). Returns uint8 [..., 32], equal to ops.keccak.keccak256.
    `block` (a power of two) is the number of rows per program;
    `call_options` go to pl.pallas_call (the CPU tests run the kernel in
    the Pallas interpreter this way)."""
    data = jnp.asarray(data, dtype=jnp.uint8)
    lead, width = data.shape[:-1], data.shape[-1]
    data = data.reshape(-1, width)
    u = data.shape[0]
    if lengths is None:
        lens = jnp.full((u,), width, jnp.int32)
    else:
        lens = jnp.asarray(lengths, dtype=jnp.int32).reshape(u)
    if u == 0:
        return jnp.zeros(lead + (32,), jnp.uint8)
    w4 = -(-width // 4) * 4
    if w4 != width:
        data = jnp.pad(data, ((0, 0), (0, w4 - width)))
    digest = _sponge(data, lens, block=block,
                     call_options=tuple(sorted(call_options.items())))
    return digest.reshape(lead + (32,))
