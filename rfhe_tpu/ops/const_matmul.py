"""Fused-digit modular matmul against a *constant* matrix (int8 matmul).

`matmul_mod` (ops/matmul_mod.py) digitizes both operands, which costs
nd_a x nd_b small matmuls plus one Montgomery recombination per digit-weight
class.  When one operand is a compile-time constant (NTT stage matrices,
CRT base-conversion tables, BSGS diagonals), we can do much better: fold the
data-digit weight 2^(7j) into the constant *before* digitizing it,

    W_j = (W << 7j) mod q,   j = 0..nd_x-1,

balanced-digitize each W_j in base 256 (digits in [-128, 127], int8-exact),
concatenate the j-blocks along the contraction axis AND stack the nd_w
balanced digits of W along the output axis:

    (W @ x) mod q = sum_i 2^(8i) * ( [Wd_i | over j] @ [x digits | over j] )

so the whole j-sum rides INSIDE one int8 contraction and all nd_w digit
accumulators come out of ONE int8 matmul (vs nd_a x nd_b separate matmuls
when both operands are digitized, ops/matmul_mod.py).

The data-digit width xb is chosen per plan (_choose_xb): smallest digit
count first, then narrow enough that adjacent digit accumulators combine
exactly in int32 (acc_even + 256*acc_odd), which halves the Montgomery
recombination work — for a 30-bit modulus the whole reduction is 2
mont_muls per output.

Signed accumulators are recombined through their uint32 bit pattern:
mont_mul(bits(acc), 2^(8i)*R) = acc*2^(8i) + s*2^(32+8i) (mod q) for
acc < 0 (s = 1); with R = 2^32 the fix constant 2^(32+8i) mod q IS the
Montgomery weight, so one conditional subtraction of weights_mont restores
the exact value.

This replaces the per-element multiply loops the reference runs on
GPU/OpenMP (rfhe_framewk/src/four_step_ntt_protected.cpp:109-137
`matmul_mod`, baseConv.cu:85-120 `crt_kernel`): the multiplies move into
one exact integer matmul, with the mod-q algebra done once per output.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from .u32 import mont_mul, sub_mod, add_mod

_WB = 8          # constant digit width (balanced base 256)


def _choose_xb(qbits: int, k: int) -> int:
    """Pick the data-digit width: smallest digit count first (fewest int8
    MACs), then the narrowest digits at that count (headroom to keep the
    int32 pairwise recombination exact, halving the Montgomery work)."""
    best = None
    for xb in (7, 6, 5, 4):
        nd_x = -(-qbits // xb)
        K = nd_x * k
        if K * ((1 << xb) - 1) * 128 >= (1 << 31):
            continue                     # unpaired int32 overflow: unusable
        pair_ok = K * ((1 << xb) - 1) * 128 * 257 < (1 << 31)
        # cost model (inherited; not measured on the GPU): one int8
        # digit-pass ~0.15 of one Montgomery recombination group
        groups = -(-4 // 2) if pair_ok else 4    # nd_w≈4 for 30-bit primes
        cost = nd_x * 0.15 + groups
        if best is None or cost < best[0]:
            best = (cost, xb)
    if best is None:
        raise ValueError(f"contraction {k} too large for int8 digits")
    return best[1]


def _balanced_digits(v: np.ndarray, nd: int) -> np.ndarray:
    """Balanced base-256 digits of uint32 values: (nd, *v.shape) int8 with
    v == sum_i d_i * 256^i and d_i in [-128, 127]."""
    x = v.astype(np.int64)
    out = np.empty((nd,) + v.shape, dtype=np.int8)
    for i in range(nd):
        d = x & 0xFF
        d = np.where(d >= 128, d - 256, d)
        out[i] = d
        x = (x - d) >> _WB
    if not (x == 0).all():
        raise ValueError(f"nd={nd} too small for values up to {v.max()}")
    return out


def _digitize_all(folded, nd_min: int):
    """Balanced-digitize every matrix in `folded` with the smallest digit
    count that is exact for all of them.  Returns (digit list, nd)."""
    nd = nd_min
    while True:
        try:
            return [_balanced_digits(f, nd) for f in folded], nd
        except ValueError:
            nd += 1


@dataclass(frozen=True)
class ConstMatPlan:
    """Digitized constant matrices for stacked-limb modular matmuls.

    side="left":   y = (W_l @ x_l) mod q_l      W: (L, m, k), x: (L, k, c)
    side="right":  y = (x_l @ W_l) mod q_l      W: (L, k, m), x: (L, c, k)

    All tables carry a leading limb axis L; q_arr/qinv_arr are (L,).
    """

    side: str
    L: int
    m: int
    k: int
    xb: int                    # data digit width
    nd_x: int
    nd_w: int
    pair: bool                 # combine adjacent digit accs in int32 first
    Wd: jnp.ndarray            # left: (L, nd_w*m, nd_x*k); right: (L, nd_x*k, nd_w*m)
    q_arr: jnp.ndarray         # (L,) uint32
    qinv_arr: jnp.ndarray      # (L,) uint32 (-q^-1 mod 2^32)
    # Montgomery group weights 2^(8i)*R mod q; since R = 2^32 this equals
    # 2^(32+8i) mod q, which is ALSO the negative-accumulator fix constant
    # (bits(acc) = acc + 2^32 for acc < 0, and mont_mul is linear), so one
    # table serves both uses.
    weights_mont: jnp.ndarray  # (n_groups, L) uint32

    @classmethod
    def make(cls, W: np.ndarray, primes, qinv_negs, side: str = "left"
             ) -> "ConstMatPlan":
        """W: (L, m, k) for side="left", (L, k, m) for side="right",
        uint32 residues with W[l] < primes[l]."""
        assert side in ("left", "right")
        W = np.asarray(W, dtype=np.uint32)
        assert W.ndim == 3
        L = W.shape[0]
        primes = [int(q) for q in primes]
        qinv_negs = [int(x) for x in qinv_negs]
        assert len(primes) == L
        if side == "left":
            m, k = W.shape[1], W.shape[2]
        else:
            k, m = W.shape[1], W.shape[2]
        qmax = max(primes)
        xb = _choose_xb(qmax.bit_length(), k)
        nd_x = -(-qmax.bit_length() // xb)
        R = 1 << 32
        per_limb = []
        nd_w = -(-qmax.bit_length() // _WB)
        for l, q in enumerate(primes):
            Wl = W[l].astype(np.uint64)
            folded = [((Wl << (xb * j)) % q).astype(np.uint32)
                      for j in range(nd_x)]
            digs, nd = _digitize_all(folded, nd_w)
            nd_w = max(nd_w, nd)
            per_limb.append(folded)
        Wd = np.zeros((nd_w, L) + ((m, nd_x * k) if side == "left"
                                   else (nd_x * k, m)), dtype=np.int8)
        for l, q in enumerate(primes):
            digs = [_balanced_digits(f, nd_w) for f in per_limb[l]]
            for i in range(nd_w):
                blocks = [d[i] for d in digs]
                if side == "left":
                    Wd[i, l] = np.concatenate(blocks, axis=1)    # (m, nd_x*k)
                else:
                    Wd[i, l] = np.concatenate(blocks, axis=0)    # (nd_x*k, m)
        # Pairwise int32 combine (acc_even + 256*acc_odd) is exact only while
        # |acc| * 257 < 2^31; |acc| <= K * 128 * (2^xb - 1).
        K = nd_x * k
        pair = nd_w > 1 and K * 128 * ((1 << xb) - 1) * 257 < (1 << 31)
        step = 2 if pair else 1
        groups = list(range(0, nd_w, step))
        wmont = np.empty((len(groups), L), dtype=np.uint32)
        for gi, i in enumerate(groups):
            for l, q in enumerate(primes):
                wmont[gi, l] = ((1 << (_WB * i)) * R) % q
        # stack digit blocks along the output axis: one int8 matmul total
        if side == "left":
            Wd2 = Wd.transpose(1, 0, 2, 3).reshape(L, nd_w * m, nd_x * k)
        else:
            Wd2 = Wd.transpose(1, 2, 0, 3).reshape(L, nd_x * k, nd_w * m)
        return cls(
            side=side, L=L, m=m, k=k, xb=xb, nd_x=nd_x, nd_w=nd_w, pair=pair,
            Wd=jnp.asarray(Wd2),
            q_arr=jnp.asarray(np.asarray(primes, dtype=np.uint32)),
            qinv_arr=jnp.asarray(np.asarray(qinv_negs, dtype=np.uint32)),
            weights_mont=jnp.asarray(wmont),
        )

    def take(self, idx) -> "ConstMatPlan":
        idx = np.asarray(idx)
        return ConstMatPlan(
            side=self.side, L=int(idx.size), m=self.m, k=self.k, xb=self.xb,
            nd_x=self.nd_x, nd_w=self.nd_w, pair=self.pair, Wd=self.Wd[idx],
            q_arr=self.q_arr[idx], qinv_arr=self.qinv_arr[idx],
            weights_mont=self.weights_mont[:, idx],
        )

    @property
    def group_starts(self):
        """Digit index each recombination group starts at (exponent 8*i)."""
        step = 2 if self.pair else 1
        return list(range(0, self.nd_w, step))

    def digit_groups(self, x: jnp.ndarray):
        """The matmul part: digitize x, one int8 einsum against the stacked
        constant, return the int32 partial accumulators per recombination
        group (pairs pre-combined in int32).  Group g carries weight
        2^(8*group_starts[g]).

        left:  x (..., L, k, c) -> groups (..., L, m, c)
        right: x (..., L, c, k) -> groups (..., L, c, m)

        Data keeps its (..., L, row, col) layout throughout — the einsum
        contracts in place and XLA folds any operand transpose into the matmul
        pass, so no materialized layout change happens outside the matmul.
        """
        axis = -2 if self.side == "left" else -1
        mask = (1 << self.xb) - 1
        digs = [((x >> (self.xb * j)) & mask).astype(jnp.int8)
                for j in range(self.nd_x)]
        xd = jnp.concatenate(digs, axis=axis)
        if self.side == "left":
            # (L, nd_w*m, K) @ (..., L, K, t): batch dims broadcast
            p = jnp.matmul(self.Wd, xd, preferred_element_type=jnp.int32)
            p = p.reshape(p.shape[:-2] + (self.nd_w, self.m, p.shape[-1]))
            parts = [p[..., i, :, :] for i in range(self.nd_w)]
        else:
            p = jnp.matmul(xd, self.Wd, preferred_element_type=jnp.int32)
            p = p.reshape(p.shape[:-1] + (self.nd_w, self.m))
            parts = [p[..., i, :] for i in range(self.nd_w)]
        out = []
        for i in self.group_starts:
            g = parts[i]
            if self.pair and i + 1 < self.nd_w:
                g = g + (parts[i + 1] << 8)         # exact in int32 (bounded)
            out.append(g)
        return out

    def apply(self, x: jnp.ndarray) -> jnp.ndarray:
        """left: x (..., L, k, c) -> (..., L, m, c);
        right: x (..., L, c, k) -> (..., L, c, m).
        x entries must be < q_l (uint32)."""
        qb = self.q_arr[:, None, None]
        qinvb = self.qinv_arr[:, None, None]
        acc = None
        for gi, g in enumerate(self.digit_groups(x)):
            w = self.weights_mont[gi][:, None, None]
            term = mont_mul(g.astype(jnp.uint32), w, qb, qinvb)
            term = sub_mod(term, jnp.where(g < 0, w, jnp.uint32(0)), qb)
            acc = term if acc is None else add_mod(acc, term, qb)
        return acc
