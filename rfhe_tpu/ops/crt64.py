"""Device-side CRT reconstruction of small centered values to 64-bit words.

Replaces the host object-int CRT in scheme decryption (the `rns_to_signed`
path): after decryption the plaintext coefficient x = [c(s)]_Q is *small*
(|x| ≪ Q — CKKS: scale·m + noise; BGV: m + t·e), so the full 600-bit CRT
is unnecessary.  We reconstruct x mod 2^64 exactly with u32-pair arithmetic:

    x + ⌊Q/4⌋ = Σ_j y_j·Q̂_j − e·Q,   y_j = |(x+⌊Q/4⌋)·Q̂_j^{-1}|_{q_j}

The ⌊Q/4⌋ offset centers the rational Σ y_j/q_j at e + 1/4, keeping the
overflow count e a robust f32 round (margin 1/4 ≫ k·2^-24 float error ≫
|x|/Q) — the same e-recovery problem the BEHZ conversions solve with m̃,
solved here with an additive offset because x is known-small.

Exact for |x| < 2^62.  Device counterpart of the exact Garner CRT the
reference runs per-element in CUDA (rfhe_framewk/src/baseConv.cu:85-120).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..numth import mod_inv, shoup_precompute
from . import u32


@dataclass(frozen=True)
class Crt64Plan:
    moduli: Tuple[int, ...]
    q_arr: jnp.ndarray          # (k,) uint32
    yw: jnp.ndarray             # (k,) |Q̂_j^{-1}|_{q_j}
    yw_shoup: jnp.ndarray
    q4_mod: jnp.ndarray         # (k,) ⌊Q/4⌋ mod q_j
    qhat64: jnp.ndarray         # (k, 2) [hi, lo] of Q̂_j mod 2^64
    q64: Tuple[int, int]        # (hi, lo) of Q mod 2^64
    q4_64: Tuple[int, int]      # (hi, lo) of ⌊Q/4⌋ mod 2^64
    inv_q: jnp.ndarray          # (k,) float32 1/q_j

    @classmethod
    def make(cls, moduli: Sequence[int]) -> "Crt64Plan":
        moduli = tuple(int(q) for q in moduli)
        Q = math.prod(moduli)
        q4 = Q // 4
        qhat = [Q // q for q in moduli]
        yw = [mod_inv(qhat[j] % q, q) for j, q in enumerate(moduli)]
        M = (1 << 64) - 1
        split = lambda v: ((v >> 32) & 0xFFFFFFFF, v & 0xFFFFFFFF)
        return cls(
            moduli=moduli,
            q_arr=jnp.asarray(np.array(moduli, dtype=np.uint32)),
            yw=jnp.asarray(np.array(yw, dtype=np.uint32)),
            yw_shoup=jnp.asarray(np.array(
                [shoup_precompute(w, q) for w, q in zip(yw, moduli)],
                dtype=np.uint32)),
            q4_mod=jnp.asarray(np.array([q4 % q for q in moduli],
                                        dtype=np.uint32)),
            qhat64=jnp.asarray(np.array([split(h & M) for h in qhat],
                                        dtype=np.uint32)),
            q64=split(Q & M),
            q4_64=split(q4 & M),
            inv_q=jnp.asarray(np.array([1.0 / q for q in moduli],
                                       dtype=np.float32)),
        )


def _neg64(hi, lo):
    """Two's complement of a 64-bit (hi, lo) pair: ~x + 1; the +1 carries
    into hi exactly when lo == 0."""
    nlo = (~lo) + jnp.uint32(1)
    nhi = (~hi) + jnp.where(lo == 0, jnp.uint32(1), jnp.uint32(0))
    return nhi, nlo


def crt_to_words(x: jnp.ndarray, plan: Crt64Plan
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """x: (..., k, n) uint32 residues of a small centered value.
    Returns (hi, lo) uint32 (..., n): the value mod 2^64 (two's complement).
    Exact for |value| < 2^62."""
    k = len(plan.moduli)
    q = plan.q_arr[:, None]
    xo = u32.add_mod(x, plan.q4_mod[:, None], q)
    y = u32.mul_mod_shoup(xo, plan.yw[:, None], plan.yw_shoup[:, None], q)
    # overflow count e = round(Σ y_j/q_j − 1/4)
    f = jnp.sum(y.astype(jnp.float32) * plan.inv_q[:, None], axis=-2)
    e = jnp.round(f - 0.25).astype(jnp.uint32)
    # S = Σ y_j·(Q̂_j mod 2^64) mod 2^64
    hi = jnp.zeros(x.shape[:-2] + x.shape[-1:], dtype=jnp.uint32)
    lo = jnp.zeros_like(hi)
    for j in range(k):
        _, p_hi, p_lo = u32.mul_u64_u32(plan.qhat64[j, 0], plan.qhat64[j, 1],
                                        y[..., j, :])
        hi, lo = u32.add64(hi, lo, p_hi, p_lo)
    # subtract e·Q and the ⌊Q/4⌋ offset (mod 2^64)
    _, t_hi, t_lo = u32.mul_u64_u32(jnp.uint32(plan.q64[0]),
                                    jnp.uint32(plan.q64[1]), e)
    hi, lo = u32.add64(hi, lo, *_neg64(t_hi, t_lo))
    o_hi = jnp.full_like(hi, plan.q4_64[0])
    o_lo = jnp.full_like(lo, plan.q4_64[1])
    hi, lo = u32.add64(hi, lo, *_neg64(o_hi, o_lo))
    return hi, lo


def words_to_signed(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Host: (hi, lo) uint32 pairs -> signed int64 (two's complement)."""
    v = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(lo).astype(np.uint64)
    return v.astype(np.int64)
