"""Vectorized 32-bit modular arithmetic in jnp.uint32 (elementwise path).

32x32->64 products are emulated with 16-bit half-words (inherited from an
accelerator without 64-bit integer multiplies; a GPU has a widening
multiply, ROADMAP.md design debt 3), and general modmuls use Montgomery (R = 2^32) while
constant mults (twiddles, psi powers) use Shoup precomputation — the same
trick the reference's GPU substrate uses for root powers
(reliability_test/ntt_test.cu:40-69).

All moduli are Python ints baked in at trace time; inputs/outputs are
uint32 arrays of residues in [0, q).  Valid for odd q < 2^31.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

_M16 = 0xFFFF


def _u32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.uint32)


def mul32_parts(a: jnp.ndarray, b: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full 32x32 -> (hi, lo) uint32 product via 16-bit half-words."""
    a = a.astype(jnp.uint32)
    b = b.astype(jnp.uint32)
    al = a & _M16
    ah = a >> 16
    bl = b & _M16
    bh = b >> 16
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    mid = (ll >> 16) + (lh & _M16) + (hl & _M16)        # <= 3*(2^16-1): no overflow
    lo = (mid << 16) | (ll & _M16)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def mulhi32(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return mul32_parts(a, b)[0]


def add_mod(a: jnp.ndarray, b: jnp.ndarray, q: int) -> jnp.ndarray:
    """(a + b) mod q for a, b in [0, q), q < 2^31 (sum fits uint32)."""
    s = a + b
    return jnp.where(s >= q, s - _u32(q), s)


def sub_mod(a: jnp.ndarray, b: jnp.ndarray, q: int) -> jnp.ndarray:
    """(a - b) mod q for a, b in [0, q)."""
    d = a - b
    # underflow wraps: detect via d > a (unsigned)
    return jnp.where(b > a, d + _u32(q), d)


def neg_mod(a: jnp.ndarray, q: int) -> jnp.ndarray:
    return jnp.where(a == 0, a, _u32(q) - a)


def cond_sub(a: jnp.ndarray, q: int) -> jnp.ndarray:
    return jnp.where(a >= q, a - _u32(q), a)


def mont_mul(a: jnp.ndarray, b: jnp.ndarray, q: int, qinv_neg: int) -> jnp.ndarray:
    """Montgomery product: a*b*R^{-1} mod q, R = 2^32.

    Requires a < 2^32, b < q < 2^31 so t = (ab + mq)/R < 2q fits uint32
    (the wide `a` range is load-bearing: const_matmul.apply and
    ntt_mxu recombination pass a = bits(acc) up to 2^32-1 — negative int32
    accumulators reinterpreted as uint32).
    """
    hi, lo = mul32_parts(a, b)
    m = lo * _u32(qinv_neg)                 # low 32 bits only
    mq_hi, mq_lo = mul32_parts(m, _u32(q))
    # lo + mq_lo == 0 mod 2^32 by construction; carry = 1 iff lo != 0
    carry = (lo != 0).astype(jnp.uint32)
    t = hi + mq_hi + carry                  # < 2q < 2^32
    return cond_sub(t, q)


def to_mont(a: jnp.ndarray, q: int, qinv_neg: int, r2: int) -> jnp.ndarray:
    return mont_mul(a, _u32(r2), q, qinv_neg)


def from_mont(a: jnp.ndarray, q: int, qinv_neg: int) -> jnp.ndarray:
    return mont_mul(a, _u32(1), q, qinv_neg)


def mul_mod(a: jnp.ndarray, b: jnp.ndarray, q: int, qinv_neg: int, r2: int) -> jnp.ndarray:
    """General a*b mod q (normal domain): two Montgomery products."""
    return mont_mul(mont_mul(a, b, q, qinv_neg), _u32(r2), q, qinv_neg)


def mul_mod_shoup(x: jnp.ndarray, w, w_shoup, q: int) -> jnp.ndarray:
    """x*w mod q with Shoup-precomputed w' = floor(w*2^32/q).

    One mulhi + two low mults; result needs a single conditional subtract.
    `w`/`w_shoup` may be scalars or arrays broadcastable against x.
    """
    w = _u32(w)
    w_shoup = _u32(w_shoup)
    hi = mulhi32(x, w_shoup)
    r = x * w - hi * _u32(q)                # wrapping low-32 arithmetic: r in [0, 2q)
    return cond_sub(r, q)


def pow_mod(base: jnp.ndarray, exp: int, q: int, qinv_neg: int, r2: int) -> jnp.ndarray:
    """base^exp mod q, exp a static Python int (square-and-multiply, traced)."""
    result = jnp.full_like(base, 1, dtype=jnp.uint32)
    b = base
    e = int(exp)
    while e:
        if e & 1:
            result = mul_mod(result, b, q, qinv_neg, r2)
        b = mul_mod(b, b, q, qinv_neg, r2)
        e >>= 1
    return result


# ---------------------------------------------------------------------------
# Barrett reduction of a 64-bit (hi, lo) value — used by detector models that
# need the reference's exact Barrett pipeline stages (t = x*mu, s = t >> 2k,
# c = x - s*q) on-device.  For q < 2^31.
# ---------------------------------------------------------------------------

def add64(a_hi, a_lo, b_hi, b_lo):
    lo = a_lo + b_lo
    carry = (lo < a_lo).astype(jnp.uint32)
    return a_hi + b_hi + carry, lo


def mul_u64_u32(a_hi, a_lo, b):
    """(a_hi:a_lo) * b -> 96-bit (h2, h1, h0) little-endian u32 triple."""
    p0_hi, p0_lo = mul32_parts(a_lo, b)
    p1_hi, p1_lo = mul32_parts(a_hi, b)
    h0 = p0_lo
    h1 = p0_hi + p1_lo
    carry = (h1 < p0_hi).astype(jnp.uint32)
    h2 = p1_hi + carry
    return h2, h1, h0


def barrett_reduce64(x_hi: jnp.ndarray, x_lo: jnp.ndarray, q: int, mu: int, k: int) -> jnp.ndarray:
    """Reduce a 64-bit value x < q^2 modulo q (q < 2^31) via the reference's
    Barrett recipe with mu = floor(2^2k / q), k = bitlen(q).

    s = floor(x * mu / 2^2k) computed in 32-bit limbs; c = x - s*q with up to
    two conditional subtracts (the quotient estimate is off by at most 2).
    """
    assert q < (1 << 31)
    mu_hi, mu_lo = (mu >> 32) & 0xFFFFFFFF, mu & 0xFFFFFFFF
    # t = x * mu: x (2 limbs) * mu (up to 2 limbs) -> up to 4 limbs; we only
    # need limbs >= floor(2k/32) so compute the full product in u32 limbs.
    # partial products
    t0_hi, t0_lo = mul32_parts(x_lo, _u32(mu_lo))             # weight 0
    t1_hi, t1_lo = mul32_parts(x_hi, _u32(mu_lo))             # weight 1
    t2_hi, t2_lo = mul32_parts(x_lo, _u32(mu_hi))             # weight 1
    t3_hi, t3_lo = mul32_parts(x_hi, _u32(mu_hi))             # weight 2
    # accumulate into limbs L0..L3
    L0 = t0_lo
    L1 = t0_hi + t1_lo
    c1 = (L1 < t0_hi).astype(jnp.uint32)
    L1b = L1 + t2_lo
    c1 += (L1b < L1).astype(jnp.uint32)
    L2 = t1_hi + t2_hi
    c2 = (L2 < t1_hi).astype(jnp.uint32)
    L2b = L2 + t3_lo
    c2 += (L2b < L2).astype(jnp.uint32)
    L2c = L2b + c1
    c2 += (L2c < L2b).astype(jnp.uint32)
    L3 = t3_hi + c2
    # s = t >> 2k, 2k in (60, 62]; s < q < 2^31 so it lives in limbs 1..3
    shift = 2 * k
    word = shift // 32
    rem = shift % 32
    limbs = [L0, L1b, L2c, L3, jnp.zeros_like(L0)]
    if rem == 0:
        s = limbs[word]
    else:
        s = (limbs[word] >> rem) | (limbs[word + 1] << (32 - rem))
    # c = x - s*q in a 64-bit pair; quotient estimate is off by at most 2, so
    # c in [0, 3q) which can exceed 2^32 for q near 2^31 — keep the hi limb.
    sq_hi, sq_lo = mul32_parts(s, _u32(q))
    borrow = (sq_lo > x_lo).astype(jnp.uint32)
    c_lo = x_lo - sq_lo
    c_hi = x_hi - sq_hi - borrow
    for _ in range(2):
        ge = (c_hi > 0) | (c_lo >= q)
        b = (c_lo < q).astype(jnp.uint32)
        c_lo = jnp.where(ge, c_lo - _u32(q), c_lo)
        c_hi = jnp.where(ge, c_hi - b, c_hi)
    return c_lo


def popcount32(x: jnp.ndarray) -> jnp.ndarray:
    """Per-element bit population count (SWAR)."""
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return (x * jnp.uint32(0x01010101)) >> 24
