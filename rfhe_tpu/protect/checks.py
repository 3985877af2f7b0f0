"""ABFT detector library (L3): JAX invariant functions returning booleans.

Each detector mirrors one of the reference's protection mechanisms and is
expressed as a vectorizable device computation so campaigns can vmap over
Monte-Carlo trials, and distributed variants can psum the partial sums:

  matmul_check          col·row checksum (four_step_ntt_prot.py:185-194,
                        four_step_ntt_protected.py:78-90)
  elementwise_fold_check  Σ fold(x)·fold(t) == Σ fold(y)  (mod 2^W-1)
                        (four_step_ntt_protected.py:102-119)
  stage1_projection_check / stage2_projection_check
                        random-weight projections over the four-step stages
                        (relia_ntt_sim.py:179-189, 209-219)
  twiddle_inter_check   random-φ ABFT across the twiddle stage
                        (relia_ntt_sim.py:191-207)
  intra_fold_product_check  per-element fold-domain product verification
                        (barrett_final.py:137-142; the implementable form of
                        relia_ntt_sim.py:164-171's collision model)
  barrett_range_protected  Barrett with pre/post range windows
                        (barrett_inner.py:53-95, barrett_final.py:83-110)
  baseconv_ecc          appended checksum row through base conversion
                        (baseConv.py:42-98)
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops import u32
from ..ops.matmul_mod import DigitPlan, matmul_mod
from ..ops.modring import ModArith, sum_mod
from ..ops.u32 import mul32_parts
from .fold import fold_u32, fold_u64, fold_2s1_u32, fold_2s1_u64


def _rand_mod(key, shape, q: int) -> jnp.ndarray:
    return jax.random.randint(key, shape, 0, q, dtype=jnp.uint32)


# ---------------------------------------------------------------------------
# matmul col·row checksum
# ---------------------------------------------------------------------------

def matmul_check(A: jnp.ndarray, B: jnp.ndarray, C: jnp.ndarray,
                 arith: ModArith) -> jnp.ndarray:
    """sum(C) == col_sums(A) · row_sums(B)  (mod q).  Boolean (batched over
    leading dims)."""
    col = sum_mod(A, arith.q, axis=-2)          # (..., k)
    row = sum_mod(B, arith.q, axis=-1)          # (..., k)
    lhs = arith.dot(col, row, axis=-1)
    rhs = sum_mod(sum_mod(C, arith.q, axis=-1), arith.q, axis=-1)
    return lhs == rhs


# ---------------------------------------------------------------------------
# elementwise fold checksum (stage-2 of the 3-stage pipeline)
# ---------------------------------------------------------------------------

def elementwise_fold_check(X: jnp.ndarray, T: jnp.ndarray, Y: jnp.ndarray,
                           w: int) -> jnp.ndarray:
    """Under M = 2^w - 1: Σ fold(X_i)·fold(T_i) == Σ fold(Y_i) where
    Y = X*T mod M.  Products of folds are < 2^48: folded via u64 pairs."""
    M = (1 << w) - 1
    fx = fold_u32(X, w)
    ft = fold_u32(T, w)
    p_hi, p_lo = mul32_parts(fx, ft)
    s_in = sum_mod(fold_u64(p_hi, p_lo, w), M, axis=-1)
    s_out = sum_mod(fold_u32(Y, w), M, axis=-1)
    return s_in == s_out


# ---------------------------------------------------------------------------
# four-step NTT stage projections (operate on the (n2, n1) stage matrices)
# ---------------------------------------------------------------------------

def stage1_projection_check(A: jnp.ndarray, B: jnp.ndarray, W2: jnp.ndarray,
                            digit: DigitPlan, arith: ModArith,
                            key) -> jnp.ndarray:
    """Stage-1 (B = W2 @ A) batch check: random w over rows.
    <W2·w, rowsums(A)> == <w, rowsums(B)>  (W2 symmetric)."""
    n2 = A.shape[-2]
    s_in = sum_mod(A, arith.q, axis=-1)
    s_out = sum_mod(B, arith.q, axis=-1)
    w = _rand_mod(key, (n2,), arith.q)
    w_hat = matmul_mod(W2, w[:, None], digit)[:, 0]
    lhs = arith.dot(w_hat, s_in, axis=-1)
    rhs = arith.dot(w, s_out, axis=-1)
    return lhs == rhs


def stage2_projection_check(B: jnp.ndarray, Y: jnp.ndarray, W1T: jnp.ndarray,
                            digit: DigitPlan, arith: ModArith,
                            key) -> jnp.ndarray:
    """Stage-2 (Y = B @ W1ᵀ) batch check: random w over columns.
    <W1·w, colsums(B)> == <w, colsums(Y)>."""
    n1 = B.shape[-1]
    r_in = sum_mod(B, arith.q, axis=-2)
    r_out = sum_mod(Y, arith.q, axis=-2)
    w = _rand_mod(key, (n1,), arith.q)
    w_hat = matmul_mod(W1T.T, w[:, None], digit)[:, 0]
    lhs = arith.dot(w_hat, r_in, axis=-1)
    rhs = arith.dot(w, r_out, axis=-1)
    return lhs == rhs


def twiddle_inter_check(B_before: jnp.ndarray, B_after: jnp.ndarray,
                        T: jnp.ndarray, arith: ModArith, key) -> jnp.ndarray:
    """Random-φ ABFT across the elementwise twiddle stage:
    <φ, rowsums(B_after)> == <φ, rowsums(T ⊙ B_before)>."""
    n2 = B_before.shape[-2]
    phi = _rand_mod(key, (n2,), arith.q)
    lhs = arith.dot(phi, sum_mod(B_after, arith.q, axis=-1), axis=-1)
    weighted = arith.mul(T, B_before)
    rhs = arith.dot(phi, sum_mod(weighted, arith.q, axis=-1), axis=-1)
    return lhs == rhs


def twiddle_collision_model(B_true: jnp.ndarray, B_faulty: jnp.ndarray,
                            fold_width: int = 24) -> jnp.ndarray:
    """The reference's intra-element collision model for the twiddle stage
    (relia_ntt_sim.py:164-171): a fault is caught iff the corrupted value
    differs from the true value modulo 2^fold_width + 1.  Returns the
    per-call 'detected' boolean (any element)."""
    diff = fold_2s1_u32(B_true, fold_width) != fold_2s1_u32(B_faulty, fold_width)
    changed = B_true != B_faulty
    return jnp.any(diff & changed, axis=(-2, -1))


def intra_fold_product_check(a: jnp.ndarray, b: jnp.ndarray,
                             c_unreduced_hi: jnp.ndarray,
                             c_unreduced_lo: jnp.ndarray,
                             s_bits: int) -> jnp.ndarray:
    """Implementable per-element intra check (barrett_final.py:137-142):
    fold(a)·fold(b) == fold(a·b) over mod 2^s + 1, where c_unreduced is the
    full 64-bit product a*b.  Returns per-element ok booleans."""
    M = (1 << s_bits) + 1
    fa = fold_2s1_u32(a, s_bits)
    fb = fold_2s1_u32(b, s_bits)
    p_hi, p_lo = mul32_parts(fa, fb)
    lhs = fold_2s1_u64(p_hi, p_lo, s_bits)
    rhs = fold_2s1_u64(c_unreduced_hi, c_unreduced_lo, s_bits)
    return lhs == rhs


# ---------------------------------------------------------------------------
# Barrett with range windows
# ---------------------------------------------------------------------------

def barrett_range_protected(x_hi: jnp.ndarray, x_lo: jnp.ndarray,
                            q: int, mu: int, k: int
                            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Barrett-reduce 64-bit x with the reference's pre/post range windows
    (barrett_inner.py:53-95): pre-subtract c must lie in [0, 2q), final in
    [0, q).  Returns (reduced, ok)."""
    assert q < (1 << 31)
    mu_lo = mu & 0xFFFFFFFF
    mu_hi = (mu >> 32) & 0xFFFFFFFF
    # t = x*mu (reusing the limb logic of u32.barrett_reduce64)
    t0_hi, t0_lo = mul32_parts(x_lo, jnp.uint32(mu_lo))
    t1_hi, t1_lo = mul32_parts(x_hi, jnp.uint32(mu_lo))
    t2_hi, t2_lo = mul32_parts(x_lo, jnp.uint32(mu_hi))
    t3_hi, t3_lo = mul32_parts(x_hi, jnp.uint32(mu_hi))
    L1 = t0_hi + t1_lo
    c1 = (L1 < t0_hi).astype(jnp.uint32)
    L1b = L1 + t2_lo
    c1 = c1 + (L1b < L1).astype(jnp.uint32)
    L2 = t1_hi + t2_hi
    c2 = (L2 < t1_hi).astype(jnp.uint32)
    L2b = L2 + t3_lo
    c2 = c2 + (L2b < L2).astype(jnp.uint32)
    L2c = L2b + c1
    c2 = c2 + (L2c < L2b).astype(jnp.uint32)
    L3 = t3_hi + c2
    shift = 2 * k
    word, rem = divmod(shift, 32)
    limbs = [t0_lo, L1b, L2c, L3, jnp.zeros_like(t0_lo)]
    if rem == 0:
        s = limbs[word]
    else:
        s = (limbs[word] >> rem) | (limbs[word + 1] << (32 - rem))
    sq_hi, sq_lo = mul32_parts(s, jnp.uint32(q))
    borrow = (sq_lo > x_lo).astype(jnp.uint32)
    c_lo = x_lo - sq_lo
    c_hi = x_hi - sq_hi - borrow
    # pre-sub window: 0 <= c < 2q (c_hi must be 0 and c_lo < 2q)
    pre_ok = (c_hi == 0) & (c_lo < jnp.uint32(2 * q))
    c_red = jnp.where(c_lo >= q, c_lo - jnp.uint32(q), c_lo)
    post_ok = c_red < jnp.uint32(q)
    return c_red, pre_ok & post_ok


# ---------------------------------------------------------------------------
# Montgomery product with the intra fold check (production evaluator path)
# ---------------------------------------------------------------------------

def mont_mul_checked(a: jnp.ndarray, b: jnp.ndarray, qb, qinvb,
                     s_bits: int = 16) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """u32.mont_mul plus the reference's intra fold product check
    (barrett_final.py:137-142 adapted to Montgomery): the full 64-bit
    product a·b is verified against fold(a)·fold(b) mod 2^s+1, and the
    reduced output against the [0, q) range window.  The 64-bit product is
    shared with the reduction (XLA CSE), so a fault in the multiplier
    corrupts both the output and the checked value — and is caught by the
    independent folded re-multiplication.  Returns (out, ok) elementwise.

    s=16 default: halves the fold chunk count vs the reference's narrower
    widths (cheapest elementwise — each chunk is shift+mask+add) AND drops
    the collision bound to ~1/(2^16+1) (the fold-width ramp of
    barrett_final.py gets strictly better with wider s)."""
    qb = jnp.asarray(qb, dtype=jnp.uint32)
    qinvb = jnp.asarray(qinvb, dtype=jnp.uint32)
    hi, lo = mul32_parts(a, b)
    m = lo * qinvb
    mq_hi, _ = mul32_parts(m, qb)
    carry = (lo != 0).astype(jnp.uint32)
    t = hi + mq_hi + carry
    out = jnp.where(t >= qb, t - qb, t)
    fa = fold_2s1_u32(a, s_bits)
    fb = fold_2s1_u32(b, s_bits)
    ph, pl = mul32_parts(fa, fb)
    ok = (fold_2s1_u64(ph, pl, s_bits) == fold_2s1_u64(hi, lo, s_bits)) \
        & (out < qb)
    return out, ok


def sum_u64_exact(v: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact integer sum along the last axis of u32 values as a (hi, lo)
    u64 pair.  Backbone of the keyswitch digit-extension ECC
    (fhe/protected.py): the extension is linear over the integers mod each
    target modulus, so the exact input sum reduces to a per-limb checksum.

    Two wide `jnp.sum` reduces over the 16-bit half-word planes (each plane
    sum < 2^32 for axis length <= 2^16 — exact in u32), recombined as
    S = s_hi·2^16 + s_lo with one carry.  Replaces the log-depth
    carry-tracked halving tree, whose per-level sliced ops dominated the
    protected evaluator's ECC cost (round-5 ablation)."""
    n = v.shape[-1]
    assert n <= (1 << 16), "plane sums overflow u32 beyond 2^16 elements"
    s_lo = jnp.sum(v & jnp.uint32(0xFFFF), axis=-1, dtype=jnp.uint32)
    s_hi = jnp.sum(v >> 16, axis=-1, dtype=jnp.uint32)
    # S = s_hi·2^16 + s_lo exactly, as a u32 pair
    lo = s_lo + (s_hi << 16)
    carry = (lo < s_lo).astype(jnp.uint32)
    hi = (s_hi >> 16) + carry
    return hi, lo


# ---------------------------------------------------------------------------
# base-conversion appended-checksum ECC
# ---------------------------------------------------------------------------

def baseconv_append_checksum(residues: jnp.ndarray,
                             moduli_in) -> jnp.ndarray:
    """Append the per-limb checksum element Σ_i r_j[i] mod p_j as column N
    (baseConv.py:48-49).  residues: (..., m, N) -> (..., m, N+1)."""
    q = jnp.asarray(moduli_in, dtype=jnp.uint32)
    s = sum_mod(residues, q, axis=-1)
    return jnp.concatenate([residues, s[..., None]], axis=-1)


def baseconv_ecc_check(converted: jnp.ndarray, moduli_out) -> jnp.ndarray:
    """After converting an (m, N+1) residue matrix, verify per output limb
    that column N equals the modular sum of columns 0..N-1
    (baseConv.py:79-96).  converted: (..., m_out, N+1); returns (...,) bool."""
    q = jnp.asarray(moduli_out, dtype=jnp.uint32)
    data = converted[..., :-1]
    ecc = converted[..., -1]
    s = sum_mod(data, q, axis=-1)
    return jnp.all(s == ecc, axis=-1)
