"""Fixed-width multi-limb integers in uint32 lanes (little-endian limbs).

The reference's Barrett/Montgomery Monte-Carlo simulators work with 37-bit
primes and intermediates up to ~112 bits (t = x·mu), using Python ints /
Boost cpp_int (barret_modmul.py, montgomery_modmul.cpp).  Here those become
(..., L)-shaped uint32 arrays with static-unrolled carry chains — fully
vectorized over the 8192-element working vectors and vmappable over trials.

All widths are static (chosen per campaign); ops never allocate dynamically.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from .u32 import mul32_parts


def from_int(x: int, limbs: int) -> np.ndarray:
    out = np.zeros(limbs, dtype=np.uint32)
    for i in range(limbs):
        out[i] = (x >> (32 * i)) & 0xFFFFFFFF
    assert x >> (32 * limbs) == 0, "value too wide"
    return out


def to_int(x) -> int:
    x = np.asarray(x)
    return sum(int(v) << (32 * i) for i, v in enumerate(x))


def to_ints(x) -> list:
    """Batch version: (..., L) -> list/array of Python ints over leading dims."""
    x = np.asarray(x)
    flat = x.reshape(-1, x.shape[-1])
    return [to_int(row) for row in flat]


def add(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(..., L) + (..., L) -> (..., L) (mod 2^(32L); carries chained)."""
    L = a.shape[-1]
    out = []
    carry = jnp.zeros(a.shape[:-1], dtype=jnp.uint32)
    for i in range(L):
        s = a[..., i] + b[..., i]
        c1 = (s < a[..., i]).astype(jnp.uint32)
        s2 = s + carry
        c2 = (s2 < s).astype(jnp.uint32)
        out.append(s2)
        carry = c1 + c2
    return jnp.stack(out, axis=-1)


def sub(a: jnp.ndarray, b: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """a - b -> ((..., L), borrow_out).  borrow_out=1 means a < b."""
    L = a.shape[-1]
    out = []
    borrow = jnp.zeros(a.shape[:-1], dtype=jnp.uint32)
    for i in range(L):
        d = a[..., i] - b[..., i]
        b1 = (b[..., i] > a[..., i]).astype(jnp.uint32)
        d2 = d - borrow
        b2 = (borrow > d).astype(jnp.uint32)
        out.append(d2)
        borrow = b1 + b2
    return jnp.stack(out, axis=-1), borrow


def cmp_ge(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a >= b (both (..., L))."""
    _, borrow = sub(a, b)
    return borrow == 0


def mul(a: jnp.ndarray, b: jnp.ndarray, out_limbs: int | None = None) -> jnp.ndarray:
    """Schoolbook product: (..., La) x (..., Lb) -> (..., out_limbs).

    Column-wise accumulation: column k sums the lo halves of products with
    i+j = k, the hi halves with i+j = k−1, and the incoming carry (the wrap
    count of the previous column, always small).  Exact when
    out_limbs >= La + Lb (the default)."""
    La = a.shape[-1]
    Lb = b.shape[-1]
    Lo = out_limbs if out_limbs is not None else La + Lb
    shape = jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    parts = {}
    for i in range(La):
        for j in range(Lb):
            if i + j < Lo:
                parts[(i, j)] = mul32_parts(a[..., i], b[..., j])
    out = []
    carry = jnp.zeros(shape, dtype=jnp.uint32)
    for k in range(Lo):
        s = carry
        c = jnp.zeros(shape, dtype=jnp.uint32)
        for i in range(max(0, k - Lb + 1), min(La, k + 1)):
            lo = parts[(i, k - i)][1]
            s = s + lo
            c = c + (s < lo).astype(jnp.uint32)
        for i in range(max(0, k - Lb), min(La, k)):
            if (i, k - 1 - i) in parts:
                hi = parts[(i, k - 1 - i)][0]
                s = s + hi
                c = c + (s < hi).astype(jnp.uint32)
        out.append(s)
        carry = c
    return jnp.stack(out, axis=-1)


def shift_right(x: jnp.ndarray, bits: int, out_limbs: int | None = None) -> jnp.ndarray:
    """x >> bits (static shift), keeping out_limbs limbs."""
    L = x.shape[-1]
    Lo = out_limbs if out_limbs is not None else L
    word, rem = divmod(bits, 32)
    out = []
    zero = jnp.zeros_like(x[..., 0])
    for i in range(Lo):
        src = i + word
        lo = x[..., src] if src < L else zero
        if rem == 0:
            out.append(lo)
        else:
            hi = x[..., src + 1] if src + 1 < L else zero
            out.append((lo >> rem) | (hi << (32 - rem)))
    return jnp.stack(out, axis=-1)


def xor_bit(x: jnp.ndarray, bitpos: jnp.ndarray) -> jnp.ndarray:
    """Flip bit `bitpos` (traced scalar or broadcastable) of each (..., L)
    value."""
    L = x.shape[-1]
    idx = jnp.arange(L, dtype=jnp.uint32)
    word = (bitpos // 32).astype(jnp.uint32)
    bit = (bitpos % 32).astype(jnp.uint32)
    mask = jnp.where(idx == word[..., None], jnp.uint32(1) << bit[..., None],
                     jnp.uint32(0))
    return x ^ mask


def bit_length(x: jnp.ndarray) -> jnp.ndarray:
    """Bit length of each (..., L) value (0 for 0)."""
    L = x.shape[-1]
    res = jnp.zeros(x.shape[:-1], dtype=jnp.uint32)
    for i in range(L):
        w = x[..., i]
        bl = _bit_length32(w)
        res = jnp.where(w != 0, bl + 32 * i, res)
    return res


def _bit_length32(w: jnp.ndarray) -> jnp.ndarray:
    r = jnp.zeros_like(w)
    v = w
    for shift in (16, 8, 4, 2, 1):
        big = v >= (1 << shift)
        r = jnp.where(big, r + shift, r)
        v = jnp.where(big, v >> shift, v)
    return r + (v > 0).astype(jnp.uint32)


def fold_mod(x: jnp.ndarray, w: int) -> jnp.ndarray:
    """Value mod 2^w - 1 via w-bit chunks across all limbs (2 <= w <= 32)."""
    assert 2 <= w <= 32, f"fold width {w} out of supported range [2, 32]"
    from .u32 import add_mod
    L = x.shape[-1]
    M = (1 << w) - 1
    mask = jnp.uint32(M)
    acc = jnp.zeros(x.shape[:-1], dtype=jnp.uint32)
    o = 0
    total = 32 * L
    zero = jnp.zeros_like(x[..., 0])
    while o < total:
        word, rem = divmod(o, 32)
        lo = x[..., word]
        if rem == 0 and w == 32:
            c = lo
        elif rem + w <= 32:
            c = (lo >> rem) & mask
        else:
            hi = x[..., word + 1] if word + 1 < L else zero
            c = ((lo >> rem) | (hi << (32 - rem))) & mask
        c = jnp.where(c == mask, jnp.uint32(0), c)      # c <= M: normalize
        if w == 32:
            s = acc + c
            acc = s + (s < acc).astype(jnp.uint32)       # end-around carry
        else:
            acc = add_mod(acc, c, M)                     # M <= 2^31 - 1: safe
        o += w
    if w == 32:
        acc = jnp.where(acc == mask, jnp.uint32(0), acc)
    return acc


def fold_2s1(x: jnp.ndarray, s: int) -> jnp.ndarray:
    """Value mod 2^s + 1 via alternating-sign s-bit chunks (2 <= s <= 30)."""
    assert 2 <= s <= 30, f"fold width {s} out of supported range [2, 30]"
    from .u32 import add_mod, sub_mod
    L = x.shape[-1]
    M = (1 << s) + 1
    mask = jnp.uint32((1 << s) - 1)
    acc = jnp.zeros(x.shape[:-1], dtype=jnp.uint32)
    o = 0
    sign = 1
    total = 32 * L
    zero = jnp.zeros_like(x[..., 0])
    while o < total:
        word, rem = divmod(o, 32)
        lo = x[..., word]
        if rem + s <= 32:
            c = (lo >> rem) & mask
        else:
            hi = x[..., word + 1] if word + 1 < L else zero
            c = ((lo >> rem) | (hi << (32 - rem))) & mask
        acc = add_mod(acc, c, M) if sign > 0 else sub_mod(acc, c, M)
        sign = -sign
        o += s
    return acc


def mod_small(x: jnp.ndarray, m: int) -> jnp.ndarray:
    """Value mod m for m < 2^31, via Horner over limbs with Barrett."""
    from ..numth import barrett_constants
    from .u32 import barrett_reduce64
    mu, k = barrett_constants(m)
    L = x.shape[-1]
    r = jnp.zeros(x.shape[:-1], dtype=jnp.uint32)
    w32 = (1 << 32) % m
    for i in range(L - 1, -1, -1):
        # r = (r * 2^32 + limb_i) mod m
        hi, lo = mul32_parts(r, jnp.uint32(w32))
        r = barrett_reduce64(hi, lo, m, mu, k)
        limb_mod = barrett_reduce64(jnp.zeros_like(x[..., i]), x[..., i], m, mu, k)
        from .u32 import add_mod
        r = add_mod(r, limb_mod, m)
    return r


def cond_sub_big(c: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """One conditional subtract: c - m where c >= m (both (..., L))."""
    d, borrow = sub(c, jnp.broadcast_to(m, c.shape))
    return jnp.where((borrow == 0)[..., None], d, c)


def barrett_reduce_big(x: jnp.ndarray, q: int, mu: int, k: int,
                       out_limbs: int) -> jnp.ndarray:
    """x mod q via Barrett for arbitrary-width q (x < q^2), multi-limb.
    mu = floor(2^2k / q), k = bitlen(q)."""
    Lq = -(-(k + 1) // 32)
    Lmu = -(-(mu.bit_length()) // 32)
    mu_l = jnp.asarray(from_int(mu, Lmu))
    q_l = jnp.asarray(from_int(q, max(Lq, out_limbs)))
    t = mul(x, mu_l)
    s = shift_right(t, 2 * k, Lq + 1)
    sn = mul(s, q_l[:Lq], out_limbs + 1)
    c, _ = sub(_fit(x, out_limbs + 1), sn)
    qv = _fit(q_l, out_limbs + 1)
    c = cond_sub_big(cond_sub_big(c, qv), qv)
    return c[..., :out_limbs]


def _fit(x: jnp.ndarray, limbs: int) -> jnp.ndarray:
    L = x.shape[-1]
    if L == limbs:
        return x
    if L > limbs:
        return x[..., :limbs]
    pad = jnp.zeros(x.shape[:-1] + (limbs - L,), dtype=jnp.uint32)
    return jnp.concatenate([x, pad], axis=-1)


def sum_mod_big(x: jnp.ndarray, q: int, axis: int = -2) -> jnp.ndarray:
    """Modular sum of (..., n, L) values (each < q) along `axis` (default the
    element axis), for arbitrary-width q.  Widens by one limb for carries,
    tree-halves with full adds, then one Barrett reduction."""
    from ..numth import barrett_constants
    x = jnp.moveaxis(x, axis, -2)
    n = x.shape[-2]
    L = x.shape[-1]
    Lw = L + 1
    x = _fit(x, Lw)
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        pad = [(0, 0)] * (x.ndim - 2) + [(0, p - n), (0, 0)]
        x = jnp.pad(x, pad)
    while x.shape[-2] > 1:
        h = x.shape[-2] // 2
        x = add(x[..., :h, :], x[..., h:, :])
    total = x[..., 0, :]
    mu, k = barrett_constants(q)
    Lq = -(-q.bit_length() // 32)
    return barrett_reduce_big(total, q, mu, k, Lq)


def mask_to_bits(x: jnp.ndarray, nbits: jnp.ndarray) -> jnp.ndarray:
    """Keep only the low `nbits` (traced, broadcast over the leading dims) of
    each (..., L) value."""
    L = x.shape[-1]
    out = []
    for i in range(L):
        bits_here = jnp.clip(nbits.astype(jnp.int32) - 32 * i, 0, 32)
        full = bits_here >= 32
        none = bits_here == 0
        partial = (jnp.uint32(1) << bits_here.astype(jnp.uint32)) - 1
        m = jnp.where(full, jnp.uint32(0xFFFFFFFF),
                      jnp.where(none, jnp.uint32(0), partial))
        out.append(x[..., i] & m)
    return jnp.stack(out, axis=-1)
