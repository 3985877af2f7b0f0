"""Device fold checksums (elementwise): x mod (2^W - 1) and the alternating fold
x mod (2^s + 1), for u32 values and (hi, lo) u64 pairs.

These are the workhorse residue codes of the reference's detector layer
(fold_mod barret_modmul.py:62-71, four_step_ntt_protected.py:92-100;
residue_mod_2s1 barrett_final.py:46-54) implemented as branch-free chunk
sums on uint32 lanes.  u64 values are folded by extracting w-bit chunks
directly across the hi/lo boundary with static shifts (unrolled at trace
time) — no recursion, no overflow.

Supported widths: 2 <= w <= 24 (covers every width the reference sweeps).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..ops.u32 import add_mod, sub_mod


def _chunks64(hi: jnp.ndarray, lo: jnp.ndarray, w: int):
    """Yield the w-bit chunks of (hi:lo), lowest first, as u32 < 2^w."""
    mask = jnp.uint32((1 << w) - 1)
    o = 0
    while o < 64:
        if o + w <= 32:
            c = (lo >> o) & mask
        elif o < 32:
            c = ((lo >> o) | (hi << (32 - o))) & mask
        else:
            c = (hi >> (o - 32)) & mask
        yield c
        o += w


def fold_u64(hi: jnp.ndarray, lo: jnp.ndarray, w: int) -> jnp.ndarray:
    """(hi·2^32 + lo) mod (2^w - 1), 2 <= w <= 24."""
    assert 2 <= w <= 24
    M = (1 << w) - 1
    acc = jnp.zeros_like(lo)
    for c in _chunks64(hi, lo, w):
        acc = acc + c                          # <= 32 chunks of < 2^24: fits u32
        acc = (acc & jnp.uint32(M)) + (acc >> w)
    acc = (acc & jnp.uint32(M)) + (acc >> w)
    return jnp.where(acc == M, jnp.uint32(0), acc)


def fold_u32(x: jnp.ndarray, w: int) -> jnp.ndarray:
    """x mod (2^w - 1) for u32 x."""
    return fold_u64(jnp.zeros_like(x), x, w)


def fold_2s1_u64(hi: jnp.ndarray, lo: jnp.ndarray, s: int) -> jnp.ndarray:
    """(hi·2^32 + lo) mod (2^s + 1) via alternating-sign chunks."""
    assert 2 <= s <= 24
    M = (1 << s) + 1
    acc = jnp.zeros_like(lo)
    sign = 1
    for c in _chunks64(hi, lo, s):
        # chunk < 2^s < M: a valid residue
        acc = add_mod(acc, c, M) if sign > 0 else sub_mod(acc, c, M)
        sign = -sign
    return acc


def fold_2s1_u32(x: jnp.ndarray, s: int) -> jnp.ndarray:
    """x mod (2^s + 1)."""
    return fold_2s1_u64(jnp.zeros_like(x), x, s)
