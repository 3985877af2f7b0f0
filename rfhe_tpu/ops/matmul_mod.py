"""Exact modular matrix multiply via digit decomposition.

The FLOP-heavy pieces of the framework — four-step NTT stages, RNS base
conversion, BSGS diagonal matvecs — are all modular matmuls.  Matrix units
have no integer-mod datapath, so we decompose u32 residues into small
digits, do the digit-pair matmuls exactly (int8->int32 accumulate, or f32
for short contractions), and recombine partial sums with
Montgomery-weighted elementwise adds.

This replaces the reference's per-element CUDA/OpenMP loops
(rfhe_framewk/src/four_step_ntt_protected.cpp:109-137 matmul_mod,
baseConv.cu:85-120 crt_kernel) with a design that puts the work into
integer matmuls.

Exactness bounds:
  int8 path: digit base 2^7 (digits in [0,127]); partial sums bounded by
    k * n_pairs * (2^7-1)^2 < 2^31 for k <= 8192.
  f32 path: digit base 2^8; per-matmul f32 sums bounded by k * (2^8-1)^2
    which stays exactly representable (< 2^24) for k <= 256.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .u32 import add_mod, mont_mul


@dataclass(frozen=True)
class DigitPlan:
    """Static recombination constants for matmul_mod over prime q."""

    q: int
    qinv_neg: int
    digit_bits: int
    n_digits: int
    path: str  # "int8" | "f32"
    # weights[s] = (2^(digit_bits*s) * 2^32) mod q  (Montgomery-form weight so a
    # single mont_mul gives partial * 2^(digit_bits*s) mod q)
    weights_mont: Tuple[int, ...]

    @classmethod
    def make(cls, q: int, qinv_neg: int, path: str = "int8") -> "DigitPlan":
        if path == "int8":
            b = 7
        elif path == "f32":
            b = 8
        else:
            raise ValueError(path)
        nd = -(-q.bit_length() // b)
        R = 1 << 32
        weights = tuple(((1 << (b * s)) * R) % q for s in range(2 * nd - 1))
        return cls(q=q, qinv_neg=qinv_neg, digit_bits=b, n_digits=nd,
                   path=path, weights_mont=weights)

    @property
    def max_k(self) -> int:
        if self.path == "int8":
            pairs = self.n_digits
            return (1 << 31) // (pairs * (((1 << self.digit_bits) - 1) ** 2)) - 1
        return 256


def _digits(x: jnp.ndarray, plan: DigitPlan) -> List[jnp.ndarray]:
    b = plan.digit_bits
    mask = (1 << b) - 1
    out = []
    for i in range(plan.n_digits):
        d = (x >> (b * i)) & mask
        if plan.path == "int8":
            out.append(d.astype(jnp.int8))
        else:
            out.append(d.astype(jnp.float32))
    return out


def _digit_matmul(a: jnp.ndarray, b: jnp.ndarray, path: str) -> jnp.ndarray:
    if path == "int8":
        return jnp.matmul(a, b, preferred_element_type=jnp.int32)
    # HIGHEST: a GPU would otherwise run an f32 matmul in TF32
    p = jnp.matmul(a, b, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    return p.astype(jnp.int32)


def matmul_mod(a: jnp.ndarray, b: jnp.ndarray, plan: DigitPlan) -> jnp.ndarray:
    """(a @ b) mod q.  a: (..., m, k), b: (..., k, n) uint32 residues < q.

    Leading batch dims broadcast as in jnp.matmul.  k must be <= plan.max_k
    (callers chunk the contraction otherwise).
    """
    k = a.shape[-1]
    if k > plan.max_k:
        # chunk the contraction dimension and add partial results mod q
        chunk = plan.max_k
        total = None
        for s in range(0, k, chunk):
            part = matmul_mod(a[..., s:s + chunk], b[..., s:s + chunk, :], plan)
            total = part if total is None else add_mod(total, part, plan.q)
        return total

    da = _digits(a, plan)
    db = _digits(b, plan)
    nd = plan.n_digits
    # group partial products by total weight s = i + j
    acc = None
    for s in range(2 * nd - 1):
        p_s = None
        for i in range(max(0, s - nd + 1), min(nd, s + 1)):
            j = s - i
            p = _digit_matmul(da[i], db[j], plan.path)
            p_s = p if p_s is None else p_s + p
        term = mont_mul(p_s.astype(jnp.uint32), jnp.uint32(plan.weights_mont[s]),
                        plan.q, plan.qinv_neg)
        acc = term if acc is None else add_mod(acc, term, plan.q)
    return acc


def matvec_mod(mat: jnp.ndarray, vec: jnp.ndarray, plan: DigitPlan) -> jnp.ndarray:
    """(mat @ vec) mod q for vec (..., k)."""
    return matmul_mod(mat, vec[..., None], plan)[..., 0]


def np_matmul_mod(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """Host-side exact check helper (object dtype, slow)."""
    return np.array(
        (a.astype(object) @ b.astype(object)) % q, dtype=np.uint32
    )
