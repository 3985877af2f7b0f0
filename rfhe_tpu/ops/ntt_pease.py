"""Pease constant-geometry NTT: every stage is the SAME shaped computation
(butterfly first-half/second-half, write interleaved), so the full transform
compiles as one small lax.fori_loop body + a (log n, n/2) twiddle table —
two orders of magnitude less HLO than the unrolled reshape formulation
(so far faster XLA compiles than the unrolled form).

Derivation: maintain ρ_s = (current position → virtual natural-DIF position).
Stage s butterflies current pairs (i, i+n/2); their virtual indices satisfy
vb = va + m/2 (m = n >> s) by construction; the DIF twiddle is
ω^{(va mod m)·(n/m)}; outputs go to (2i, 2i+1), giving
ρ_{s+1}[2i] = va[i], ρ_{s+1}[2i+1] = va[i] + m/2.
Final slot p holds natural-DIF-output index ρ_final[p], i.e. NTT coefficient
ν(p) = bitrev(ρ_final[p]).  ν is stored in the plan; everything
order-dependent (galois slot permutations, batching slot maps) consumes ν.

Inverse: mirrored pipeline (read interleaved pairs, write halves) with
inverse twiddles; the factor n is removed by the caller's exit table.
"""
from __future__ import annotations

import os as _os
from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..numth import PrimeCtx, mod_inv, shoup_precompute
from .ntt import bit_reverse_indices
from .u32 import add_mod, sub_mod, mul_mod_shoup, mont_mul


def _pease_tables(n: int, omega: int, q: int):
    """Host-side: twiddle exponent table (log n, n/2) and final layout ρ."""
    log_n = n.bit_length() - 1
    rho = np.arange(n, dtype=np.int64)
    exps = np.empty((log_n, n // 2), dtype=np.int64)
    for s in range(log_n):
        m = n >> s
        half = m // 2
        va = rho[: n // 2]
        vb = rho[n // 2:]
        assert np.array_equal(vb, va + half), f"pairing broken at stage {s}"
        exps[s] = (va % m) * (n // m)
        new_rho = np.empty_like(rho)
        new_rho[0::2] = va
        new_rho[1::2] = va + half
        rho = new_rho
    return exps, rho


@dataclass(frozen=True)
class PeaseNttPlan:
    """Stacked-limb constant-geometry plan.  All tables are device arrays with
    leading L (limb) axis; q/qinv broadcast as (L, 1)."""

    n: int
    q_arr: jnp.ndarray            # (L,)
    qinv_arr: jnp.ndarray
    fwd_w: jnp.ndarray            # (log n, L, n/2)
    fwd_w_shoup: jnp.ndarray
    inv_w: jnp.ndarray
    inv_w_shoup: jnp.ndarray
    psi_mont: jnp.ndarray         # (L, n): ψ^i · R  (entry; carries Montgomery R)
    psi_mont_shoup: jnp.ndarray
    psi_inv_n: jnp.ndarray        # (L, n): ψ^{-i} · n^{-1} (exit)
    nu: np.ndarray                # (n,) slot -> natural NTT output index
    nu_inv: np.ndarray            # inverse permutation

    @classmethod
    def make(cls, n: int, primes) -> "PeaseNttPlan":
        primes = [int(q) for q in primes]
        L = len(primes)
        log_n = n.bit_length() - 1
        R = 1 << 32
        fwd = np.empty((log_n, L, n // 2), dtype=np.uint32)
        fwds = np.empty_like(fwd)
        inv = np.empty_like(fwd)
        invs = np.empty_like(fwd)
        psi_m = np.empty((L, n), dtype=np.uint32)
        psi_ms = np.empty_like(psi_m)
        psi_in = np.empty_like(psi_m)
        q_arr = np.empty(L, dtype=np.uint32)
        qinv_arr = np.empty(L, dtype=np.uint32)
        nu = None
        for li, q in enumerate(primes):
            ctx = PrimeCtx.make(q, n)
            omega = ctx.omega
            omega_inv = mod_inv(omega, q)
            exps, rho = _pease_tables(n, omega, q)
            if nu is None:
                rev = bit_reverse_indices(n)
                nu = rev[rho]                      # slot -> NTT coeff index
            # powers of omega (and inverse), gathered by exponent
            pow_tab = np.empty(n, dtype=np.uint32)
            pow_inv_tab = np.empty(n, dtype=np.uint32)
            v = vi = 1
            for e in range(n):
                pow_tab[e] = v
                pow_inv_tab[e] = vi
                v = (v * omega) % q
                vi = (vi * omega_inv) % q
            fwd[:, li, :] = pow_tab[exps]
            inv[:, li, :] = pow_inv_tab[exps]
            sh = np.vectorize(lambda w: shoup_precompute(int(w), q))
            fwds[:, li, :] = sh(fwd[:, li, :]).astype(np.uint32)
            invs[:, li, :] = sh(inv[:, li, :]).astype(np.uint32)
            psi_inv = mod_inv(ctx.psi, q)
            pv = R % q
            piv = ctx.n_inv % q
            for i in range(n):
                psi_m[li, i] = pv
                psi_ms[li, i] = shoup_precompute(int(pv), q)
                psi_in[li, i] = piv
                pv = (pv * ctx.psi) % q
                piv = (piv * psi_inv) % q
            q_arr[li] = q
            qinv_arr[li] = ctx.qinv_neg
        nu_inv = np.empty(n, dtype=np.int64)
        nu_inv[nu] = np.arange(n)
        return cls(
            n=n, q_arr=jnp.asarray(q_arr), qinv_arr=jnp.asarray(qinv_arr),
            fwd_w=jnp.asarray(fwd), fwd_w_shoup=jnp.asarray(fwds),
            inv_w=jnp.asarray(inv), inv_w_shoup=jnp.asarray(invs),
            psi_mont=jnp.asarray(psi_m), psi_mont_shoup=jnp.asarray(psi_ms),
            psi_inv_n=jnp.asarray(psi_in), nu=nu, nu_inv=nu_inv,
        )

    @property
    def L(self) -> int:
        return int(self.q_arr.shape[0])

    def slice(self, k: int) -> "PeaseNttPlan":
        return PeaseNttPlan(
            n=self.n, q_arr=self.q_arr[:k], qinv_arr=self.qinv_arr[:k],
            fwd_w=self.fwd_w[:, :k], fwd_w_shoup=self.fwd_w_shoup[:, :k],
            inv_w=self.inv_w[:, :k], inv_w_shoup=self.inv_w_shoup[:, :k],
            psi_mont=self.psi_mont[:k], psi_mont_shoup=self.psi_mont_shoup[:k],
            psi_inv_n=self.psi_inv_n[:k], nu=self.nu, nu_inv=self.nu_inv,
        )

    def take(self, idx) -> "PeaseNttPlan":
        idx = np.asarray(idx)
        return PeaseNttPlan(
            n=self.n, q_arr=self.q_arr[idx], qinv_arr=self.qinv_arr[idx],
            fwd_w=self.fwd_w[:, idx], fwd_w_shoup=self.fwd_w_shoup[:, idx],
            inv_w=self.inv_w[:, idx], inv_w_shoup=self.inv_w_shoup[:, idx],
            psi_mont=self.psi_mont[idx], psi_mont_shoup=self.psi_mont_shoup[idx],
            psi_inv_n=self.psi_inv_n[idx], nu=self.nu, nu_inv=self.nu_inv,
        )

    # broadcast helpers (shared protocol with StackedNttPlan)
    def qb(self, ndim: int):
        return self.q_arr.reshape((self.L,) + (1,) * ndim)

    def qinvb(self, ndim: int):
        return self.qinv_arr.reshape((self.L,) + (1,) * ndim)


def ntt(x: jnp.ndarray, plan: PeaseNttPlan) -> jnp.ndarray:
    """Cyclic forward NTT over the last axis; x: (..., L, n).  Output order:
    slot p holds NTT coefficient plan.nu[p].  Domain-agnostic."""
    n = plan.n
    log_n = n.bit_length() - 1
    q = plan.qb(1)
    shape = x.shape

    def body(s, v):
        a = v[..., : n // 2]
        b = v[..., n // 2:]
        w = jax.lax.dynamic_index_in_dim(plan.fwd_w, s, axis=0, keepdims=False)
        ws = jax.lax.dynamic_index_in_dim(plan.fwd_w_shoup, s, axis=0,
                                          keepdims=False)
        u = add_mod(a, b, q)
        t = mul_mod_shoup(sub_mod(a, b, q), w, ws, q)
        return jnp.stack([u, t], axis=-1).reshape(shape)

    return jax.lax.fori_loop(0, log_n, body, x)


def intt(x: jnp.ndarray, plan: PeaseNttPlan) -> jnp.ndarray:
    """Inverse pipeline (mirrored); result carries a factor n."""
    n = plan.n
    log_n = n.bit_length() - 1
    q = plan.qb(1)
    shape = x.shape

    def body(i, v):
        s = log_n - 1 - i
        pairs = v.reshape(shape[:-1] + (n // 2, 2))
        u = pairs[..., 0]
        t = pairs[..., 1]
        w = jax.lax.dynamic_index_in_dim(plan.inv_w, s, axis=0, keepdims=False)
        ws = jax.lax.dynamic_index_in_dim(plan.inv_w_shoup, s, axis=0,
                                          keepdims=False)
        tw = mul_mod_shoup(t, w, ws, q)
        a = add_mod(u, tw, q)
        b = sub_mod(u, tw, q)
        return jnp.concatenate([a, b], axis=-1)

    return jax.lax.fori_loop(0, log_n, body, x)


def negacyclic_ntt(x: jnp.ndarray, plan) -> jnp.ndarray:
    """ψ-premultiply (entering the Montgomery domain) + forward pipeline.

    Accepts any plan implementing the stacked-limb NTT protocol: an
    MxuNttPlan (four-step int8-matmul form — the production path,
    ops/ntt_mxu.py) dispatches to its own fwd; a PeaseNttPlan runs the XLA constant-geometry pipeline
    below."""
    fwd = getattr(plan, "fwd", None)
    if fwd is not None:
        return fwd(x)
    xm = mul_mod_shoup(x, plan.psi_mont, plan.psi_mont_shoup, plan.qb(1))
    return ntt(xm, plan)


def negacyclic_intt(x: jnp.ndarray, plan) -> jnp.ndarray:
    """Inverse pipeline + ψ^{-1}·n^{-1} exit (removes Montgomery R)."""
    inv = getattr(plan, "inv", None)
    if inv is not None:
        return inv(x)
    y = intt(x, plan)
    return mont_mul(y, plan.psi_inv_n, plan.qb(1), plan.qinvb(1))


@lru_cache(maxsize=1024)
def _galois_perm_nu(n: int, g: int) -> np.ndarray:
    """Slot permutation for X -> X^g in Pease slot order: slot p evaluates at
    ψ^(2ν(p)+1); the automorphism pulls from the slot holding exponent
    g·(2ν(p)+1) mod 2n."""
    # ν depends only on n (bitrev ∘ ρ_final), not on the modulus
    rho = np.arange(n, dtype=np.int64)
    for s in range(n.bit_length() - 1):
        half = (n >> s) // 2
        va = rho[: n // 2]
        new_rho = np.empty_like(rho)
        new_rho[0::2] = va
        new_rho[1::2] = va + half
        rho = new_rho
    nu = bit_reverse_indices(n)[rho]
    nu_inv = np.empty(n, dtype=np.int64)
    nu_inv[nu] = np.arange(n)
    p = np.empty(n, dtype=np.int32)
    for i in range(n):
        e = (g * (2 * int(nu[i]) + 1)) % (2 * n)
        p[i] = nu_inv[(e - 1) // 2]
    return p


def galois_perm(plan, g: int) -> np.ndarray:
    """Order-aware galois slot permutation: plans with their own slot layout
    (MxuNttPlan) provide a galois_perm method; the Pease layout is computed
    here."""
    meth = getattr(plan, "galois_perm", None)
    if meth is not None:
        return meth(g)
    return _galois_perm_nu(plan.n, g)
