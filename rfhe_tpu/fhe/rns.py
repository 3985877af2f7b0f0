"""RNS polynomial arithmetic over the moduli chain (L4 core).

An RnsPoly is a uint32 array of shape (L, N): limb j holds the coefficients
(or NTT-domain slots, Montgomery form) of the polynomial mod q_j.  One
stacked NTT (ops.ntt.StackedNttPlan) transforms all limbs in a single traced
program — the counterpart of the reference substrate's per-limb batched
CUDA NTT (reliability_test/ntt_test.cu:44-95).

Domain conventions (ops/ntt.py): NTT-domain slots are in the Montgomery
domain and bit-reversed order; pointwise ciphertext products are single
mont_muls (the dyadic product that dominates CKKS multiply —
BASELINE.md: 91% dyadic_product_coeffmod).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..numth import barrett_constants, mod_inv, montgomery_constants, shoup_precompute
from ..ops import u32
from ..ops import ntt_pease
from ..ops.ntt import StackedNttPlan, bit_reverse_indices
from ..ops.ntt_pease import PeaseNttPlan, negacyclic_intt, negacyclic_ntt


@dataclass(frozen=True)
class RnsContext:
    """Static tables for one moduli chain (all levels)."""

    n: int
    moduli: Tuple[int, ...]
    plan: PeaseNttPlan                       # full-chain stacked NTT tables
    # rescale tables, indexed by the level being dropped (limb k):
    #   qk_mod[k]    : (k,) uint32, q_k mod q_i for i < k
    #   qk_inv[k]    : (k,) uint32, q_k^{-1} mod q_i  (Shoup pair alongside)
    qk_mod: Tuple[jnp.ndarray, ...]
    qk_inv: Tuple[jnp.ndarray, ...]
    qk_inv_shoup: Tuple[jnp.ndarray, ...]
    # Barrett (mu, k) per limb for u32->mod-q_i reductions in base extension
    barrett_mu: Tuple[int, ...]
    barrett_k: Tuple[int, ...]

    @classmethod
    def make(cls, n: int, moduli: Sequence[int],
             ntt_impl: Optional[str] = None) -> "RnsContext":
        moduli = tuple(int(q) for q in moduli)
        impl = ntt_impl or os.environ.get("RFHE_TPU_NTT", "mxu")
        if impl == "mxu":
            from ..ops.ntt_mxu import MxuNttPlan
            plan = MxuNttPlan.make(n, moduli)
        else:
            plan = PeaseNttPlan.make(n, moduli)
        qk_mod, qk_inv, qk_inv_shoup = [], [], []
        for k in range(len(moduli)):
            qk = moduli[k]
            mods = np.array([qk % moduli[i] for i in range(k)], dtype=np.uint32)
            invs = np.array([mod_inv(qk % moduli[i], moduli[i]) if k else 0
                             for i in range(k)], dtype=np.uint32)
            shoups = np.array(
                [shoup_precompute(int(invs[i]), moduli[i]) for i in range(k)],
                dtype=np.uint32)
            qk_mod.append(jnp.asarray(mods))
            qk_inv.append(jnp.asarray(invs))
            qk_inv_shoup.append(jnp.asarray(shoups))
        mus, ks = zip(*(barrett_constants(q) for q in moduli))
        return cls(n=n, moduli=moduli, plan=plan,
                   qk_mod=tuple(qk_mod), qk_inv=tuple(qk_inv),
                   qk_inv_shoup=tuple(qk_inv_shoup),
                   barrett_mu=tuple(mus), barrett_k=tuple(ks))

    @property
    def L(self) -> int:
        return len(self.moduli)

    def q_arr(self, level: int) -> jnp.ndarray:
        return self.plan.q_arr[:level + 1]

    def plan_at(self, level: int) -> PeaseNttPlan:
        return self.plan.slice(level + 1)

    def galois_perm(self, g: int) -> np.ndarray:
        return ntt_pease.galois_perm(self.plan, g)


@lru_cache(maxsize=256)
def _galois_perm(n: int, g: int) -> np.ndarray:
    """Permutation p such that applying x -> x^g to a polynomial permutes our
    (bit-reversed, ψ-scaled) NTT slots as Y'[i] = Y[p[i]].

    Slot i evaluates m at ψ^(2·br(i)+1); the automorphism sends it to the
    slot holding exponent g·(2·br(i)+1) mod 2n.
    """
    rev = bit_reverse_indices(n)
    inv_rev = np.empty(n, dtype=np.int64)
    inv_rev[rev] = np.arange(n)
    p = np.empty(n, dtype=np.int32)
    for i in range(n):
        e = (g * (2 * int(rev[i]) + 1)) % (2 * n)
        p[i] = inv_rev[(e - 1) // 2]
    return p


# ---------------------------------------------------------------------------
# polynomial ops (functions over raw (L, N) uint32 arrays + context/level)
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclass
class RnsPoly:
    data: jnp.ndarray      # (level+1, N) uint32
    is_ntt: bool           # True: NTT/Montgomery domain, bit-reversed slots

    def tree_flatten(self):
        return (self.data,), (self.is_ntt,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(data=children[0], is_ntt=aux[0])

    @property
    def level(self) -> int:
        return self.data.shape[0] - 1


def poly_ntt(p: RnsPoly, ctx: RnsContext) -> RnsPoly:
    assert not p.is_ntt
    return RnsPoly(negacyclic_ntt(p.data, ctx.plan_at(p.level)), True)


def poly_intt(p: RnsPoly, ctx: RnsContext) -> RnsPoly:
    assert p.is_ntt
    return RnsPoly(negacyclic_intt(p.data, ctx.plan_at(p.level)), False)


def _qb(ctx: RnsContext, level: int):
    return ctx.q_arr(level)[:, None]


def poly_add(a: RnsPoly, b: RnsPoly, ctx: RnsContext) -> RnsPoly:
    assert a.is_ntt == b.is_ntt and a.level == b.level
    return RnsPoly(u32.add_mod(a.data, b.data, _qb(ctx, a.level)), a.is_ntt)


def poly_sub(a: RnsPoly, b: RnsPoly, ctx: RnsContext) -> RnsPoly:
    assert a.is_ntt == b.is_ntt and a.level == b.level
    return RnsPoly(u32.sub_mod(a.data, b.data, _qb(ctx, a.level)), a.is_ntt)


def poly_neg(a: RnsPoly, ctx: RnsContext) -> RnsPoly:
    return RnsPoly(u32.neg_mod(a.data, _qb(ctx, a.level)), a.is_ntt)


def poly_mul_pointwise(a: RnsPoly, b: RnsPoly, ctx: RnsContext) -> RnsPoly:
    """Dyadic product of two NTT-domain (Montgomery) polys."""
    assert a.is_ntt and b.is_ntt and a.level == b.level
    plan = ctx.plan_at(a.level)
    return RnsPoly(u32.mont_mul(a.data, b.data, plan.qb(1), plan.qinvb(1)), True)


def poly_automorphism(a: RnsPoly, g: int, ctx: RnsContext) -> RnsPoly:
    """Apply X -> X^g.  NTT domain: a slot permutation (gather)."""
    assert a.is_ntt, "apply automorphisms in the NTT domain"
    perm = jnp.asarray(ctx.galois_perm(g))
    return RnsPoly(a.data[:, perm], True)


def base_extend_digit(v: jnp.ndarray, j: int, level: int,
                      ctx: RnsContext) -> jnp.ndarray:
    """Extend a single-limb digit v ∈ [0, q_j)^N (coeff domain) to the full
    basis q_0..q_level: limb i gets v mod q_i (the trivial one-limb base
    extension used by dnum=L keyswitching).  Returns (level+1, N)."""
    zeros = jnp.zeros_like(v)
    out = []
    for i in range(level + 1):
        if i == j:
            out.append(v)
        elif ctx.moduli[i] > ctx.moduli[j]:
            out.append(v)          # already reduced
        else:
            out.append(u32.barrett_reduce64(
                zeros, v, ctx.moduli[i], ctx.barrett_mu[i], ctx.barrett_k[i]))
    return jnp.stack(out)


def limb_plan(ctx: RnsContext, i: int) -> PeaseNttPlan:
    """Single-limb view of the stacked plan (for per-limb INTTs)."""
    return ctx.plan.take([i])


def lift_to_limbs(v: jnp.ndarray, src_k: int, dst,
                  ctx: RnsContext, centered: bool) -> jnp.ndarray:
    """Lift coeff-domain values v ∈ [0, q_src)^(..., N) to residues mod
    each q_i, i ∈ dst, optionally via the centered representative
    [v] ∈ (-q_src/2, q_src/2].  Returns (..., len(dst), N) — the limb axis
    is inserted at -2 so leading batch dims stay leading (batched
    mod-down stacks the two keyswitch accumulators)."""
    q_src = ctx.moduli[src_k]
    over = v > (q_src // 2) if centered else None
    zeros = jnp.zeros_like(v)
    rows = []
    for i in dst:
        qi = ctx.moduli[i]
        r = v if q_src <= qi else u32.barrett_reduce64(
            zeros, v, qi, ctx.barrett_mu[i], ctx.barrett_k[i])
        if centered:
            r = jnp.where(over, u32.sub_mod(r, ctx.qk_mod[src_k][i], qi), r)
        rows.append(r)
    return jnp.stack(rows, axis=-2)


def drop_limb(data: jnp.ndarray, src_k: int, n_keep,
              ctx: RnsContext, t: Optional[int] = None) -> jnp.ndarray:
    """Exact RNS divide-and-round: given NTT-domain limbs
    data = [rows for the kept moduli] + [row for modulus src_k],
    return ((data - δ) · q_src^{-1}) mod q_i for each kept modulus.

    `n_keep` is an int (kept moduli = 0..n_keep-1, the contiguous case:
    CKKS rescale, single-special mod-down) or an explicit list of modulus
    indices (generalized hybrid keyswitch with multiple special primes).

    data may carry leading batch dims (..., nk+1, N): the keyswitch stacks
    its two accumulators so the special-limb INTT and the delta NTT run as
    ONE batched transform each instead of two half-size calls.

    CKKS / plain mode (t=None): δ = [data_src] (centered lift).
    BGV mode (t given): δ additionally satisfies δ ≡ 0 (mod t), i.e.
    δ = [c]_c − q_src·[[c]_c·q_src^{-1}]_t (both lifts centered), so the
    division leaves the message residue mod t intact up to the q_src^{-1}
    factor (tracked by the caller's correction)."""
    from ..numth import barrett_constants, mod_inv
    keep = list(range(n_keep)) if isinstance(n_keep, int) else list(n_keep)
    nk = len(keep)
    src_row = negacyclic_intt(data[..., nk:nk + 1, :], limb_plan(ctx, src_k))
    ck = src_row[..., 0, :]                           # (..., N) coeff domain
    q_src = ctx.moduli[src_k]
    delta = lift_to_limbs(ck, src_k, keep, ctx, centered=True)
    if t is not None:
        over = ck > (q_src // 2)
        mu_t, k_t = barrett_constants(t)
        inv_t = mod_inv(q_src, t)
        hi, lo = u32.mul32_parts(ck, jnp.uint32(inv_t))
        r = u32.barrett_reduce64(hi, lo, t, mu_t, k_t)
        r = jnp.where(over, u32.sub_mod(r, jnp.uint32(1), t), r)
        r_over = r > (t // 2)
        rows = []
        for ri, i in enumerate(keep):
            qi = ctx.moduli[i]
            r_c = jnp.where(r_over, u32.sub_mod(r, jnp.uint32(t % qi), qi), r)
            qs_r = u32.mul_mod(jnp.uint32(q_src % qi), r_c, qi,
                               _mont_qinv(qi), _mont_r2(qi))
            rows.append(u32.sub_mod(delta[..., ri, :], qs_r, qi))
        delta = jnp.stack(rows, axis=-2)
    delta_ntt = negacyclic_ntt(delta, ctx.plan.take(keep))
    keep_idx = np.asarray(keep)
    q_lo = ctx.plan.q_arr[keep_idx, None]
    num = u32.sub_mod(data[..., :nk, :], delta_ntt, q_lo)
    return u32.mul_mod_shoup(num, ctx.qk_inv[src_k][keep_idx, None],
                             ctx.qk_inv_shoup[src_k][keep_idx, None], q_lo)


@lru_cache(maxsize=128)
def _mont_qinv(q: int) -> int:
    return montgomery_constants(q, 32)[1]


@lru_cache(maxsize=128)
def _mont_r2(q: int) -> int:
    return montgomery_constants(q, 32)[2]


def rescale(p: RnsPoly, ctx: RnsContext) -> RnsPoly:
    """Drop the top limb k = level: c'_i = (c_i - [c_k]) · q_k^{-1} mod q_i,
    with [c_k] the centered lift (SEAL-style RNS rescale).  NTT domain in and
    out.  (Montgomery domains stay consistent: the ψ entry table carries R.)"""
    assert p.is_ntt
    k = p.level
    return RnsPoly(drop_limb(p.data, k, k, ctx), True)
