"""RNS base conversion as one int8-digit matmul (+ optional appended checksum row).

The CRT interpolation y_k[i] = Σ_j r_j[i] · ((P/p_j)(P/p_j)^{-1} mod q_k)
is literally an (N × m_in) @ (m_in × m_out) matrix product of residues by a
precomputed weight matrix — one matmul.  Per-output-limb moduli differ, so
digit-partial recombination uses *vectorized* Montgomery constants (arrays of
q_k / q_k' broadcast over columns).

Replaces the reference's per-element CUDA Garner kernel
(rfhe_framewk/src/baseConv.cu:85-120) and Python bConv
(rfhe_framewk/src/baseConv.py:10-40).  The appended-sum ECC element
(baseConv.py:42-98) becomes an extra row of the residue matrix: conversion
is linear, so the checksum row converts alongside the data and the invariant
`out[N] == Σ_i out[i] (mod q_k)` transfers — see protect/checks.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..numth import base_conv_matrix, montgomery_constants
from .u32 import add_mod, mont_mul

_DIGIT_BITS = 7
_DIGIT_MASK = (1 << _DIGIT_BITS) - 1


@dataclass(frozen=True)
class BaseConvPlan:
    moduli_in: Tuple[int, ...]
    moduli_out: Tuple[int, ...]
    weight_digits: jnp.ndarray   # (n_digits, m_in, m_out) int8
    n_digits: int
    q_out: jnp.ndarray           # (m_out,) uint32
    qinv_out: jnp.ndarray        # (m_out,) uint32
    scale_mont: jnp.ndarray      # (n_digits_total, m_out) uint32: 2^(7s)·R mod q_k

    @classmethod
    def make(cls, moduli_in: Sequence[int], moduli_out: Sequence[int]) -> "BaseConvPlan":
        W = np.array(base_conv_matrix(moduli_in, moduli_out), dtype=np.uint64)
        return cls.from_matrix(W, moduli_in, moduli_out)

    @classmethod
    def from_matrix(cls, W: np.ndarray, moduli_in: Sequence[int],
                    moduli_out: Sequence[int]) -> "BaseConvPlan":
        """Plan for out[k] = Σ_j r_j · W[j,k] mod q_k with an explicit weight
        matrix (entries already reduced mod q_k).  Used by the BEHZ BFV
        conversions, which pre-scale residues by Q̂_j^{-1} mod q_j so the
        conversion overflow stays < m_in (exactness-critical), unlike the
        reference's folded-weight form (rfhe_framewk/src/baseConv.py:27-29)."""
        W = np.asarray(W, dtype=np.uint64)
        maxbits = max(int(q).bit_length() for q in moduli_out)
        nd = -(-maxbits // _DIGIT_BITS)
        wd = np.stack(
            [((W >> (_DIGIT_BITS * s)) & _DIGIT_MASK).astype(np.int8) for s in range(nd)]
        )
        qinv = [montgomery_constants(q, 32)[1] for q in moduli_out]
        R = 1 << 32
        # residues decompose into ceil(32/7)=5 digits; total weight classes
        nd_r = -(-32 // _DIGIT_BITS)
        n_s = nd + nd_r - 1
        scale = np.array(
            [[((1 << (_DIGIT_BITS * s)) * R) % q for q in moduli_out] for s in range(n_s)],
            dtype=np.uint32,
        )
        return cls(
            moduli_in=tuple(int(p) for p in moduli_in),
            moduli_out=tuple(int(q) for q in moduli_out),
            weight_digits=jnp.asarray(wd),
            n_digits=nd,
            q_out=jnp.asarray(np.array(moduli_out, dtype=np.uint32)),
            qinv_out=jnp.asarray(np.array(qinv, dtype=np.uint32)),
            scale_mont=jnp.asarray(scale),
        )


def base_conv(residues: jnp.ndarray, plan: BaseConvPlan) -> jnp.ndarray:
    """residues: (..., m_in, N) uint32, residues[..., j, i] = x_i mod p_j.
    Returns (..., m_out, N) uint32 with out[..., k, i] = y_i mod q_k."""
    r = jnp.swapaxes(residues, -1, -2)  # (..., N, m_in)
    nd_r = -(-32 // _DIGIT_BITS)
    acc = None
    for s in range(plan.scale_mont.shape[0]):
        p_s = None
        for i in range(max(0, s - plan.n_digits + 1), min(nd_r, s + 1)):
            j = s - i
            if j >= plan.n_digits:
                continue
            rd = ((r >> (_DIGIT_BITS * i)) & _DIGIT_MASK).astype(jnp.int8)
            p = jnp.matmul(rd, plan.weight_digits[j], preferred_element_type=jnp.int32)
            p_s = p if p_s is None else p_s + p
        if p_s is None:
            continue
        term = mont_mul(p_s.astype(jnp.uint32), plan.scale_mont[s],
                        plan.q_out, plan.qinv_out)
        acc = term if acc is None else add_mod(acc, term, plan.q_out)
    return jnp.swapaxes(acc, -1, -2)
