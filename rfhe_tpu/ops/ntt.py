"""Single-chip NTT/INTT kernels (jnp formulation; Pallas fused variant in
pallas_ntt.py builds on the same plan).

Design (a rebuild, not a port):
  * DIF (decimation-in-frequency) forward with natural-order input and
    bit-reversed output; DIT inverse consumes bit-reversed and emits natural.
    Each stage is a reshape + slice + vectorized Shoup butterfly — no gathers,
    no bit-reverse permutation pass, fully fusible by XLA and batched over
    (ciphertext poly, RNS limb) leading axes.
  * Values travel in the Montgomery domain (x̃ = x·R mod q): the negacyclic
    ψ-premultiply table carries the R factor in, so pointwise products in the
    NTT domain are single mont_muls, and the ψ⁻¹·n⁻¹ exit table removes R.
  * All twiddle constants are Shoup-precomputed (one mulhi + 2 mullo per
    butterfly mult), the same constant-mult trick the reference's GPU
    substrate uses (reliability_test/ntt_test.cu:40-69 Shoup root powers).

Reference parity: ntt/intt semantics match rfhe_framewk/src/ntt.py:38-62 and
negaclic_ntt.py:86-109 (verified bit-exactly in tests via the oracle).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..numth import PrimeCtx, mod_inv, shoup_precompute
from .u32 import add_mod, sub_mod, mul_mod_shoup, mont_mul


def bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@dataclass(frozen=True)
class NttPlan:
    """Precomputed device tables for one (n, q) pair."""

    ctx: PrimeCtx
    # forward stage twiddles, stage s operates on blocks of m = n >> s
    fwd_w: Tuple[jnp.ndarray, ...]        # each (m/2,) uint32
    fwd_w_shoup: Tuple[jnp.ndarray, ...]
    inv_w: Tuple[jnp.ndarray, ...]        # inverse twiddles, same shapes
    inv_w_shoup: Tuple[jnp.ndarray, ...]
    psi_mont: jnp.ndarray                 # psi^i * R mod q  (entry table)
    psi_mont_shoup: jnp.ndarray
    psi_inv_n: jnp.ndarray                # psi^{-i} * n^{-1} mod q (exit table)

    @classmethod
    def make(cls, n: int, q: int) -> "NttPlan":
        ctx = PrimeCtx.make(q, n)
        omega = ctx.omega
        R = 1 << 32
        log_n = n.bit_length() - 1
        fwd_w, fwd_ws, inv_w, inv_ws = [], [], [], []
        omega_inv = mod_inv(omega, q)
        for s in range(log_n):
            m = n >> s
            half = m // 2
            wm = pow(omega, n // m, q)
            wmi = pow(omega_inv, n // m, q)
            tw = np.empty(half, dtype=np.uint32)
            twi = np.empty(half, dtype=np.uint32)
            tws = np.empty(half, dtype=np.uint32)
            twis = np.empty(half, dtype=np.uint32)
            w = wi = 1
            for j in range(half):
                tw[j] = w
                twi[j] = wi
                tws[j] = shoup_precompute(w, q)
                twis[j] = shoup_precompute(wi, q)
                w = (w * wm) % q
                wi = (wi * wmi) % q
            fwd_w.append(jnp.asarray(tw))
            fwd_ws.append(jnp.asarray(tws))
            inv_w.append(jnp.asarray(twi))
            inv_ws.append(jnp.asarray(twis))
        psi_i = np.empty(n, dtype=np.uint32)
        psi_is = np.empty(n, dtype=np.uint32)
        psi_inv_n = np.empty(n, dtype=np.uint32)
        psi_inv = mod_inv(ctx.psi, q)
        v = R % q
        vi = ctx.n_inv % q
        for i in range(n):
            psi_i[i] = v
            psi_is[i] = shoup_precompute(int(v), q)
            psi_inv_n[i] = vi
            v = (v * ctx.psi) % q
            vi = (vi * psi_inv) % q
        return cls(
            ctx=ctx,
            fwd_w=tuple(fwd_w), fwd_w_shoup=tuple(fwd_ws),
            inv_w=tuple(inv_w), inv_w_shoup=tuple(inv_ws),
            psi_mont=jnp.asarray(psi_i), psi_mont_shoup=jnp.asarray(psi_is),
            psi_inv_n=jnp.asarray(psi_inv_n),
        )

    @property
    def n(self) -> int:
        return self.ctx.n

    @property
    def q(self) -> int:
        return self.ctx.q

    # broadcast helpers shared with StackedNttPlan (scalar case: no-ops)
    def qb(self, ndim: int):
        return self.q

    def qinvb(self, ndim: int):
        return self.ctx.qinv_neg

    def stage_w(self, s: int, inverse: bool = False):
        return (self.inv_w[s], self.inv_w_shoup[s]) if inverse else \
            (self.fwd_w[s], self.fwd_w_shoup[s])


@dataclass(frozen=True)
class StackedNttPlan:
    """Per-limb NTT tables stacked along a leading L axis so one traced NTT
    transforms all RNS limbs at once: x has shape (..., L, n), twiddles
    broadcast as (L, 1, half), moduli as (L, 1, 1).  This is the RNS-batched
    transform the CUDA substrate expresses as `batch_size` limbs per launch
    (reliability_test/ntt_test.cu:44-95) — here it is one XLA program."""

    n: int
    q_arr: jnp.ndarray            # (L,) uint32
    qinv_arr: jnp.ndarray         # (L,)
    fwd_w: Tuple[jnp.ndarray, ...]       # each (L, m/2)
    fwd_w_shoup: Tuple[jnp.ndarray, ...]
    inv_w: Tuple[jnp.ndarray, ...]
    inv_w_shoup: Tuple[jnp.ndarray, ...]
    psi_mont: jnp.ndarray         # (L, n)
    psi_mont_shoup: jnp.ndarray
    psi_inv_n: jnp.ndarray

    @classmethod
    def make(cls, n: int, primes) -> "StackedNttPlan":
        plans = [NttPlan.make(n, int(q)) for q in primes]
        stack = lambda xs: jnp.stack(list(xs))
        return cls(
            n=n,
            q_arr=jnp.asarray(np.array([p.q for p in plans], dtype=np.uint32)),
            qinv_arr=jnp.asarray(
                np.array([p.ctx.qinv_neg for p in plans], dtype=np.uint32)),
            fwd_w=tuple(stack(p.fwd_w[s] for p in plans)
                        for s in range(len(plans[0].fwd_w))),
            fwd_w_shoup=tuple(stack(p.fwd_w_shoup[s] for p in plans)
                              for s in range(len(plans[0].fwd_w))),
            inv_w=tuple(stack(p.inv_w[s] for p in plans)
                        for s in range(len(plans[0].inv_w))),
            inv_w_shoup=tuple(stack(p.inv_w_shoup[s] for p in plans)
                              for s in range(len(plans[0].inv_w))),
            psi_mont=stack(p.psi_mont for p in plans),
            psi_mont_shoup=stack(p.psi_mont_shoup for p in plans),
            psi_inv_n=stack(p.psi_inv_n for p in plans),
        )

    @property
    def L(self) -> int:
        return int(self.q_arr.shape[0])

    def slice(self, k: int) -> "StackedNttPlan":
        """Plan restricted to the first k limbs (level-dropped ciphertexts)."""
        return StackedNttPlan(
            n=self.n, q_arr=self.q_arr[:k], qinv_arr=self.qinv_arr[:k],
            fwd_w=tuple(w[:k] for w in self.fwd_w),
            fwd_w_shoup=tuple(w[:k] for w in self.fwd_w_shoup),
            inv_w=tuple(w[:k] for w in self.inv_w),
            inv_w_shoup=tuple(w[:k] for w in self.inv_w_shoup),
            psi_mont=self.psi_mont[:k],
            psi_mont_shoup=self.psi_mont_shoup[:k],
            psi_inv_n=self.psi_inv_n[:k],
        )

    def qb(self, ndim: int):
        """q broadcastable against an (..., L, *tail) array with `ndim` tail
        dims after the L axis."""
        return self.q_arr.reshape((self.L,) + (1,) * ndim)

    def qinvb(self, ndim: int):
        return self.qinv_arr.reshape((self.L,) + (1,) * ndim)

    def stage_w(self, s: int, inverse: bool = False):
        w, ws = ((self.inv_w[s], self.inv_w_shoup[s]) if inverse
                 else (self.fwd_w[s], self.fwd_w_shoup[s]))
        return w[:, None, :], ws[:, None, :]


def ntt(x: jnp.ndarray, plan) -> jnp.ndarray:
    """Cyclic forward NTT over the last axis: natural in, bit-reversed out.

    Domain-agnostic: Shoup constant-mults preserve whatever domain x is in.
    Works for both NttPlan (x: (..., n)) and StackedNttPlan (x: (..., L, n)).
    """
    n = plan.n
    shape = x.shape
    assert shape[-1] == n
    lead = shape[:-1]
    q2 = plan.qb(2)
    log_n = n.bit_length() - 1
    for s in range(log_n):
        m = n >> s
        half = m // 2
        xr = x.reshape(lead + (n // m, m))
        a = xr[..., :half]
        b = xr[..., half:]
        u = add_mod(a, b, q2)
        d = sub_mod(a, b, q2)
        w, ws = plan.stage_w(s)
        v = mul_mod_shoup(d, w, ws, q2)
        x = jnp.concatenate([u, v], axis=-1).reshape(shape)
    return x


def intt(x: jnp.ndarray, plan) -> jnp.ndarray:
    """Cyclic inverse NTT: bit-reversed in, natural out.  Result carries an
    extra factor n (removed by the caller's exit table or explicit n_inv)."""
    n = plan.n
    shape = x.shape
    lead = shape[:-1]
    q2 = plan.qb(2)
    log_n = n.bit_length() - 1
    for s in reversed(range(log_n)):
        m = n >> s
        half = m // 2
        xr = x.reshape(lead + (n // m, m))
        u = xr[..., :half]
        v = xr[..., half:]
        w, ws = plan.stage_w(s, inverse=True)
        t = mul_mod_shoup(v, w, ws, q2)
        hi = add_mod(u, t, q2)
        lo = sub_mod(u, t, q2)
        x = jnp.concatenate([hi, lo], axis=-1).reshape(shape)
    return x


def negacyclic_ntt(x: jnp.ndarray, plan) -> jnp.ndarray:
    """Negacyclic forward: ψ-premultiply (entering the Montgomery domain),
    then cyclic NTT.  Output: Montgomery-domain, bit-reversed order."""
    xm = mul_mod_shoup(x, plan.psi_mont, plan.psi_mont_shoup, plan.qb(1))
    return ntt(xm, plan)


def negacyclic_intt(x: jnp.ndarray, plan) -> jnp.ndarray:
    """Negacyclic inverse: cyclic INTT then ψ⁻¹·n⁻¹ exit table, which also
    removes the Montgomery factor via mont_mul.  Output: normal domain,
    natural order."""
    y = intt(x, plan)
    return mont_mul(y, plan.psi_inv_n, plan.qb(1), plan.qinvb(1))


def pointwise_mul(a: jnp.ndarray, b: jnp.ndarray, plan) -> jnp.ndarray:
    """Pointwise product of two Montgomery-domain NTT vectors (stays in
    domain): the dyadic product at the heart of HMul
    (cf. seal dyadic_product_coeffmod, BASELINE.md CKKS multiply 91%)."""
    return mont_mul(a, b, plan.qb(1), plan.qinvb(1))


def poly_mul_negacyclic(a: jnp.ndarray, b: jnp.ndarray, plan) -> jnp.ndarray:
    """Full negacyclic polynomial product mod (x^n + 1, q)."""
    A = negacyclic_ntt(a, plan)
    B = negacyclic_ntt(b, plan)
    return negacyclic_intt(pointwise_mul(A, B, plan), plan)
