"""L0 number-theory utilities (host side, exact Python integers).

These feed *static* kernel parameters (primes, roots, Barrett/Montgomery/CRT
constants) into the JAX/Pallas compute path.  Everything here runs at trace
time; nothing is jitted.

Reference parity: the reference inlines these helpers in every file
(e.g. /root/reference/rfhe_framewk/src/ntt_test/relia_ntt_sim.py:11-58,
four_step_ntt_protected.py:17-61, barret_modmul.py:21-59,
montgomery.py:44-49, baseConv.py:100-111).  Here they are a single shared,
tested module.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Sequence, Tuple

# deterministic Miller-Rabin witness sets
_MR_BASES_32 = (2, 7, 61)
_MR_BASES_64 = (2, 325, 9375, 28178, 450775, 9780504, 1795265022)
_SMALL_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 2^64; strong probable-prime above."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    bases = _MR_BASES_32 if n < (1 << 32) else _MR_BASES_64
    if n >= (1 << 64):
        bases = _MR_BASES_64 + (3, 5, 7, 11, 13)
    for a in bases:
        if a % n == 0:
            continue
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def next_prime_ge(n: int) -> int:
    if n <= 2:
        return 2
    if n % 2 == 0:
        n += 1
    while not is_prime(n):
        n += 2
    return n


def find_prime_with_bitlen(bitlen: int, rng: random.Random) -> int:
    """Random prime of exact bit length (reference four_step_ntt_protected.py:53)."""
    if bitlen < 2:
        raise ValueError("bitlen must be >= 2")
    while True:
        n = (1 << (bitlen - 1)) | rng.getrandbits(bitlen - 1) | 1
        if is_prime(n):
            return n


def find_ntt_primes(
    n: int, bit_width: int, count: int = 1, negacyclic: bool = True
) -> List[int]:
    """Largest `count` primes q < 2^bit_width with q ≡ 1 (mod 2n) (negacyclic)
    or q ≡ 1 (mod n).

    Reference: relia_ntt_sim.py:32-43 searches k*2N+1 downward from 2^bits.
    """
    step = 2 * n if negacyclic else n
    limit = 1 << bit_width
    start = ((limit - 1) // step) * step + 1
    out: List[int] = []
    q = start
    while q > (1 << (bit_width - 1)) and len(out) < count:
        if is_prime(q):
            out.append(q)
        q -= step
    if len(out) < count:
        raise ValueError(f"not enough NTT primes: n={n} bits={bit_width} need={count}")
    return out


def find_ntt_prime(n: int, bit_width: int, negacyclic: bool = True) -> int:
    return find_ntt_primes(n, bit_width, 1, negacyclic)[0]


def _factorize(n: int) -> List[int]:
    """Prime factors (unique) by trial division + recursion; n up to ~2^64 with
    smooth-ish cofactors (NTT primes are k*2^m+1 with small k)."""
    fs = set()
    d = 2
    while d * d <= n:
        while n % d == 0:
            fs.add(d)
            n //= d
        d += 1 if d == 2 else 2
        if d > 10_000_000 and n > 1:
            # large cofactor: if prime record it, else give up on exactness
            if is_prime(n):
                fs.add(n)
                n = 1
            break
    if n > 1:
        fs.add(n)
    return sorted(fs)


@lru_cache(maxsize=None)
def primitive_root(q: int) -> int:
    """Smallest generator of (Z/qZ)* for prime q (verified via q-1 factors)."""
    if q == 2:
        return 1
    factors = _factorize(q - 1)
    for g in range(2, 1000):
        if all(pow(g, (q - 1) // f, q) != 1 for f in factors):
            return g
    raise ValueError(f"no primitive root found for {q}")


def root_of_unity(order: int, q: int) -> int:
    """Primitive `order`-th root of unity mod q (verified)."""
    if (q - 1) % order != 0:
        raise ValueError(f"order {order} does not divide q-1 for q={q}")
    g = primitive_root(q)
    w = pow(g, (q - 1) // order, q)
    # verification: w^order == 1 and w^(order/p) != 1 for prime p | order
    assert pow(w, order, q) == 1
    for f in _factorize(order):
        assert pow(w, order // f, q) != 1
    return w


def psi_negacyclic(n: int, q: int) -> int:
    """Primitive 2n-th root ψ with ψ^n ≡ -1 (mod q): the negacyclic weight."""
    psi = root_of_unity(2 * n, q)
    assert pow(psi, n, q) == q - 1
    return psi


def mod_inv(a: int, m: int) -> int:
    return pow(a, -1, m)


# ---------------------------------------------------------------------------
# Barrett / Montgomery / Shoup constants
# ---------------------------------------------------------------------------

def barrett_constants(q: int) -> Tuple[int, int]:
    """(mu, k): k = bitlen(q), mu = floor(2^(2k) / q).

    Matches the reference convention (barret_modmul.py:55-59); note
    barrett_final.py uses K=(q-1).bit_length() which is identical for
    non-power-of-two q.
    """
    k = q.bit_length()
    mu = (1 << (2 * k)) // q
    return mu, k


def montgomery_constants(q: int, word_bits: int = 32) -> Tuple[int, int, int]:
    """(R, qinv_neg, r2) for Montgomery arithmetic with R = 2^word_bits.

    qinv_neg = -q^{-1} mod R (the REDC m' constant, montgomery.py:44-49),
    r2 = R^2 mod q (to enter the Montgomery domain).
    Requires odd q < R.
    """
    if q % 2 == 0 or q >= (1 << word_bits):
        raise ValueError("Montgomery requires odd q < R")
    R = 1 << word_bits
    qinv = pow(q, -1, R)
    qinv_neg = (-qinv) % R
    r2 = (R * R) % q
    return R, qinv_neg, r2


def shoup_precompute(w: int, q: int, word_bits: int = 32) -> int:
    """Shoup constant w' = floor(w * 2^word_bits / q) for fast const-mult.

    a*w mod q = lo_word(a*w) - lo_word(hi_word(a*w') * q), + cond. subtract.
    The Phantom GPU NTT uses the same precomputation for root powers
    (reliability_test/ntt_test.cu:40-69 "Shoup root powers").
    """
    return (w << word_bits) // q


# ---------------------------------------------------------------------------
# CRT / RNS constants (base conversion)
# ---------------------------------------------------------------------------

def crt_constants(moduli: Sequence[int]) -> Tuple[int, List[int], List[int]]:
    """(P, hat_p, inv_hat_p): P = prod p_j, hat_p[j] = P/p_j,
    inv_hat_p[j] = hat_p[j]^{-1} mod p_j.  (baseConv.py:17-18)."""
    P = math.prod(moduli)
    hat_p = [P // p for p in moduli]
    inv_hat_p = [pow(hat_p[j], -1, moduli[j]) for j in range(len(moduli))]
    return P, hat_p, inv_hat_p


def base_conv_matrix(moduli_in: Sequence[int], moduli_out: Sequence[int]) -> List[List[int]]:
    """M[j][k] = (hat_p[j] * inv_hat_p[j]) mod q_out[k]: the RNS base-conversion
    weight matrix.  Approximate CRT interpolation:
        y_k = sum_j ((r_j * inv_hat_p[j]) mod p_j) * (hat_p[j] mod q_k)  mod q_k
    but the reference uses the unreduced form r_j * (hat_p[j]*inv_hat_p[j] mod q_k)
    (baseConv.py:27-29); we precompute per-(j,k) weights for the int8 digit matmul.
    """
    P, hat_p, inv_hat_p = crt_constants(moduli_in)
    return [
        [(hat_p[j] * inv_hat_p[j]) % qk for qk in moduli_out]
        for j in range(len(moduli_in))
    ]


def generate_crt_primes(limbs: int, bitwidth: int, rng: random.Random) -> List[int]:
    """Distinct primes of exact bitwidth (baseConv.py:100-111)."""
    primes: List[int] = []
    seen = set()
    while len(primes) < limbs:
        cand = rng.getrandbits(bitwidth) | (1 << (bitwidth - 1)) | 1
        p = next_prime_ge(cand)
        if p.bit_length() == bitwidth and p not in seen:
            primes.append(p)
            seen.add(p)
    return primes


# ---------------------------------------------------------------------------
# Bundled per-prime context
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PrimeCtx:
    """All static constants for one NTT prime, feeding device kernels."""

    q: int
    n: int                 # ring degree the roots were built for
    psi: int               # primitive 2n-th root (negacyclic weight)
    omega: int             # psi^2: primitive n-th root for the cyclic NTT
    n_inv: int             # n^{-1} mod q
    mu: int                # Barrett
    k: int
    qinv_neg: int          # Montgomery -q^{-1} mod 2^32
    r2: int                # 2^64 mod q

    @classmethod
    def make(cls, q: int, n: int) -> "PrimeCtx":
        psi = psi_negacyclic(n, q)
        mu, k = barrett_constants(q)
        _, qinv_neg, r2 = montgomery_constants(q, 32)
        return cls(
            q=q, n=n, psi=psi, omega=(psi * psi) % q,
            n_inv=mod_inv(n, q), mu=mu, k=k, qinv_neg=qinv_neg, r2=r2,
        )
