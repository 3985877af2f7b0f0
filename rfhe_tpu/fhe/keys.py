"""Key generation and hybrid keyswitching (L4).

Keyswitch design: hybrid GHS with one special prime p and per-limb digits
(dnum = L, α = 1) — the production-grade construction the reference's
substrate libraries (SEAL/Phantom `switch_key`, BASELINE.md: 19.8% of
rotation) implement, re-derived as vectorized JAX programs:

  digits are plain limb residues  D_j(c) = [c]_{q_j}
  ksk_j = (b_j, a_j) over basis (q_0..q_{L-1}, p):
      b_j = −a_j·s + e_j + p·ẽ_j·s'   where [p·ẽ_j]_{q_i} = p·δ_ij
  KS(c) = Σ_j NTT(extend(D_j(c))) ⊙ ksk_j, then mod-down by p.

The CRT idempotents ẽ_j satisfy [ẽ_j]_{q_i} = δ_ij at EVERY level, so one
key serves all levels (slice limbs).  Noise after KS ≈ Σ_j q_j·e_j / p ≈ L·e.

Key material is test-grade (ternary secrets, σ=3.2 gaussians) — the
reference likewise uses library defaults for its fault campaigns
(reliability_test/dotprod_test.cu:73-75).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import u32
from .rns import (
    RnsContext, RnsPoly, base_extend_digit, drop_limb, lift_to_limbs,
    negacyclic_ntt, poly_ntt,
)


@dataclass
class SecretKey:
    s_ntt: jnp.ndarray       # (L_full, N) NTT/Montgomery domain incl. special
    s_coeff: np.ndarray      # (N,) ternary in {-1, 0, 1} (host, for debugging)


@dataclass
class PublicKey:
    b: jnp.ndarray           # (L_ct, N) NTT domain (ciphertext primes only)
    a: jnp.ndarray


@jax.tree_util.register_pytree_node_class
@dataclass
class KeySwitchKey:
    """b, a: (n_digits, L_full, N) NTT domain over (q_0..q_{L-1}, p)."""
    b: jnp.ndarray
    a: jnp.ndarray

    def tree_flatten(self):
        return (self.b, self.a), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(b=children[0], a=children[1])


def _rns_from_signed(coeffs: np.ndarray, moduli) -> np.ndarray:
    """Signed integer coefficients -> (L, N) uint32 residues."""
    out = np.empty((len(moduli), coeffs.shape[-1]), dtype=np.uint32)
    for i, q in enumerate(moduli):
        out[i] = np.mod(coeffs.astype(np.int64), q).astype(np.uint32)
    return out


def _sample_ternary(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(-1, 2, size=n).astype(np.int64)


def _sample_gaussian(rng: np.random.Generator, n: int, sigma: float) -> np.ndarray:
    return np.round(rng.normal(0.0, sigma, size=n)).astype(np.int64)


def _sample_uniform_rns(rng: np.random.Generator, moduli, n: int) -> np.ndarray:
    return np.stack([
        rng.integers(0, q, size=n, dtype=np.uint64).astype(np.uint32)
        for q in moduli
    ])


@dataclass
class KeyGen:
    ctx: RnsContext              # full basis: ciphertext primes + special
    n_ct_limbs: int              # number of ciphertext primes (excl. special)
    sigma: float = 3.2

    def gen_secret(self, rng: np.random.Generator) -> SecretKey:
        s = _sample_ternary(rng, self.ctx.n)
        s_rns = _rns_from_signed(s, self.ctx.moduli)
        s_ntt = negacyclic_ntt(jnp.asarray(s_rns), self.ctx.plan)
        return SecretKey(s_ntt=s_ntt, s_coeff=s)

    def gen_public(self, sk: SecretKey, rng: np.random.Generator) -> PublicKey:
        L = self.n_ct_limbs
        moduli = self.ctx.moduli[:L]
        a = jnp.asarray(_sample_uniform_rns(rng, moduli, self.ctx.n))
        e = _rns_from_signed(_sample_gaussian(rng, self.ctx.n, self.sigma), moduli)
        e_ntt = negacyclic_ntt(jnp.asarray(e), self.ctx.plan.slice(L))
        q = self.ctx.plan.q_arr[:L, None]
        qinv = self.ctx.plan.qinv_arr[:L, None]
        b = u32.sub_mod(e_ntt, u32.mont_mul(a, sk.s_ntt[:L], q, qinv), q)
        return PublicKey(b=b, a=a)

    def gen_keyswitch(self, sk: SecretKey, s_prime_ntt: jnp.ndarray,
                      rng: np.random.Generator,
                      noise_factor: int = 1,
                      dnum: Optional[int] = None) -> KeySwitchKey:
        """Key switching s' -> s.  s_prime_ntt: (L_full, N) NTT domain.
        noise_factor scales the gaussian noise (t for BGV keys).

        dnum digits: ciphertext limbs partition into dnum contiguous groups
        of α = ceil(L/dnum); key j carries P·ẽ_j·s' on its group's limbs,
        with P the product of the α special primes.  dnum=None -> per-limb
        digits (α=1).  Vectorized over digits and jit-compiled."""
        ctx = self.ctx
        L = self.n_ct_limbs
        n = ctx.n
        n_sp = len(ctx.moduli) - L
        if dnum is None:
            dnum = -(-L // max(1, n_sp))  # α = n_sp by construction
        groups = _digit_groups(L, dnum)
        import math
        P_sp = math.prod(ctx.moduli[L:])
        from ..numth import shoup_precompute
        a = np.stack([_sample_uniform_rns(rng, ctx.moduli, n)
                      for _ in range(len(groups))])
        e = np.stack([
            _rns_from_signed(
                noise_factor * _sample_gaussian(rng, n, self.sigma), ctx.moduli)
            for _ in range(len(groups))
        ])
        gi_idx, l_idx, pl, pl_s, ql = [], [], [], [], []
        for gi, grp in enumerate(groups):
            for l in grp:
                gi_idx.append(gi)
                l_idx.append(l)
                v = P_sp % ctx.moduli[l]
                pl.append(v)
                pl_s.append(shoup_precompute(v, ctx.moduli[l]))
                ql.append(ctx.moduli[l])
        b, a = self._build_jit()(
            jnp.asarray(a), jnp.asarray(e), sk.s_ntt, s_prime_ntt,
            jnp.asarray(np.array(gi_idx, dtype=np.int32)),
            jnp.asarray(np.array(l_idx, dtype=np.int32)),
            jnp.asarray(np.array(pl, dtype=np.uint32)),
            jnp.asarray(np.array(pl_s, dtype=np.uint32)),
            jnp.asarray(np.array(ql, dtype=np.uint32)))
        return KeySwitchKey(b=b, a=a)

    def _build_jit(self):
        """Cached jitted key-pair builder (one compile per KeyGen/shape)."""
        if not hasattr(self, "_build_fn"):
            ctx = self.ctx

            def build(a, e, s_ntt, s_prime, gi_idx, l_idx, pl, pl_s, ql):
                q = ctx.plan.q_arr[:, None]
                qinv = ctx.plan.qinv_arr[:, None]
                e_ntt = negacyclic_ntt(e, ctx.plan)
                b = u32.sub_mod(e_ntt, u32.mont_mul(a, s_ntt, q, qinv), q)
                # + P·ẽ_g·s' on each group's (g, l) limbs
                add_d = u32.mul_mod_shoup(s_prime[l_idx], pl[:, None],
                                          pl_s[:, None], ql[:, None])
                return b.at[gi_idx, l_idx].set(
                    u32.add_mod(b[gi_idx, l_idx], add_d, ql[:, None])), a

            object.__setattr__(self, "_build_fn", jax.jit(build))
        return self._build_fn

    def gen_relin(self, sk: SecretKey, rng: np.random.Generator) -> KeySwitchKey:
        """Relinearization key: s' = s^2."""
        q = self.ctx.plan.q_arr[:, None]
        qinv = self.ctx.plan.qinv_arr[:, None]
        s2 = u32.mont_mul(sk.s_ntt, sk.s_ntt, q, qinv)
        return self.gen_keyswitch(sk, s2, rng)

    def gen_galois(self, sk: SecretKey, g: int,
                   rng: np.random.Generator) -> KeySwitchKey:
        """Galois key for automorphism X -> X^g: s' = σ_g(s)."""
        perm = jnp.asarray(self.ctx.galois_perm(g))
        s_g = sk.s_ntt[:, perm]
        return self.gen_keyswitch(sk, s_g, rng)


def _digit_groups(L: int, dnum: int):
    """Partition limbs 0..L-1 into dnum contiguous groups of α = ceil(L/dnum)."""
    alpha = -(-L // dnum)
    return [list(range(g * alpha, min((g + 1) * alpha, L)))
            for g in range(dnum) if g * alpha < L]


from functools import lru_cache


@lru_cache(maxsize=4096)
def _group_ext_consts(moduli: tuple, G: tuple, lim: tuple):
    """Fast-base-extension constants for digit group G at the active basis
    `lim`: tilde_l = (Q_G/q_l)^{-1} mod q_l and W[l][i] = (Q_G/q_l) mod q_i,
    each with Shoup companions."""
    import math
    from ..numth import mod_inv, shoup_precompute
    QG = math.prod(moduli[l] for l in G)
    tilde, tilde_s = [], []
    W, W_s = [], []
    for l in G:
        hat = QG // moduli[l]
        tl = mod_inv(hat % moduli[l], moduli[l])
        tilde.append(tl)
        tilde_s.append(shoup_precompute(tl, moduli[l]))
        W.append([hat % moduli[i] for i in lim])
        W_s.append([shoup_precompute(hat % moduli[i], moduli[i]) for i in lim])
    return (np.array(tilde, dtype=np.uint32), np.array(tilde_s, dtype=np.uint32),
            np.array(W, dtype=np.uint32), np.array(W_s, dtype=np.uint32))


def compute_digits(d_coeff: jnp.ndarray, level: int, ctx: RnsContext,
                   n_ct_limbs: int, dnum: Optional[int] = None,
                   with_ecc: bool = False):
    """Digit decomposition + base extension for the hybrid keyswitch: returns
    (dig (n_used, n_lim, N) coeff-domain, used group indices, lim basis).

    with_ecc=True additionally returns refs (n_used, n_lim) uint32: the
    appended-checksum references Σ_N dig[g, i] mod q_i predicted from exact
    u64 sums of the INPUTS (the JAX rebuild of baseConv.py:42-98's
    appended-sum element; linearity of the extension mod each target
    modulus makes the column sum checkable from one exact input sum per
    source limb).  The protected evaluator (fhe/protected.py) consumes
    this — ONE digit implementation serves the plain and protected paths."""
    from ..ops.modring import sum_mod
    from ..protect.checks import sum_u64_exact
    L = n_ct_limbs
    n_sp = len(ctx.moduli) - L
    if dnum is None:
        dnum = L
    groups_full = _digit_groups(L, dnum)
    active = level + 1
    sp_idx = list(range(L, L + n_sp))
    lim = list(range(active)) + sp_idx
    moduli = ctx.moduli
    digits = []
    used = []
    ecc_singles = []        # (digit_idx, input row)
    ecc_groups = []         # (digit_idx, stacked r', W, W_s)
    for gi, grp in enumerate(groups_full):
        G = [l for l in grp if l < active]
        if not G:
            continue
        used.append(gi)
        if len(G) == 1:
            # single-limb digit: residue extension (exact)
            v = d_coeff[G[0]]
            zeros = jnp.zeros_like(v)
            ext = []
            for i in lim:
                if i == G[0] or moduli[i] > moduli[G[0]]:
                    ext.append(v)
                else:
                    ext.append(u32.barrett_reduce64(
                        zeros, v, moduli[i], ctx.barrett_mu[i],
                        ctx.barrett_k[i]))
            digits.append(jnp.stack(ext))
            if with_ecc:
                ecc_singles.append((len(digits) - 1, v))
        else:
            # grouped digit [d]_{Q_G}: fast base extension
            tilde, tilde_s, W, W_s = _group_ext_consts(
                tuple(moduli), tuple(G), tuple(lim))
            rprime = [
                u32.mul_mod_shoup(d_coeff[l], int(tilde[li]), int(tilde_s[li]),
                                  moduli[l])
                for li, l in enumerate(G)
            ]
            ext = []
            for ii, i in enumerate(lim):
                qi = moduli[i]
                acc = None
                zeros = jnp.zeros_like(rprime[0])
                for li, l in enumerate(G):
                    r = rprime[li]
                    if moduli[l] >= qi:
                        r = u32.barrett_reduce64(zeros, r, qi,
                                                 ctx.barrett_mu[i],
                                                 ctx.barrett_k[i])
                    term = u32.mul_mod_shoup(r, int(W[li, ii]),
                                             int(W_s[li, ii]), qi)
                    acc = term if acc is None else u32.add_mod(acc, term, qi)
                ext.append(acc)
            digits.append(jnp.stack(ext))
            if with_ecc:
                ecc_groups.append((len(digits) - 1, jnp.stack(rprime),
                                   W, W_s))
    dig = jnp.stack(digits)
    if with_ecc:
        # Checksum references, VECTORIZED across digits (round-5 ablation:
        # the per-digit scalar-Barrett loops here cost more than every
        # projection check combined).  Single-limb digits: one exact sum
        # over the stacked inputs, one vector Barrett per target modulus.
        # Grouped digits: Σ_N ext = Σ_l W[l,i]·(Σ_N r'_l) mod q_i — the
        # exact sums of r' reduce per modulus as an (α,)-vector.
        ref_rows: list = [None] * len(digits)
        if ecc_singles:
            sv = jnp.stack([v for _, v in ecc_singles])
            s_hi, s_lo = sum_u64_exact(sv)                       # (ns,)
            mat = jnp.stack([
                u32.barrett_reduce64(s_hi, s_lo, moduli[i],
                                     ctx.barrett_mu[i], ctx.barrett_k[i])
                for i in lim], axis=-1)                          # (ns, n_lim)
            for row, (di, _) in enumerate(ecc_singles):
                ref_rows[di] = mat[row]
        for di, rp, W, W_s in ecc_groups:
            r_hi, r_lo = sum_u64_exact(rp)                       # (α,)
            cols = []
            for ii, i in enumerate(lim):
                qi = moduli[i]
                s_red = u32.barrett_reduce64(r_hi, r_lo, qi,
                                             ctx.barrett_mu[i],
                                             ctx.barrett_k[i])
                terms = u32.mul_mod_shoup(s_red, jnp.asarray(W[:, ii]),
                                          jnp.asarray(W_s[:, ii]), qi)
                cols.append(sum_mod(terms, qi, axis=-1))
            ref_rows[di] = jnp.stack(cols)
        return dig, used, lim, jnp.stack(ref_rows)
    return dig, used, lim


def keyswitch(d_coeff: jnp.ndarray, ksk: KeySwitchKey, level: int,
              ctx: RnsContext, n_ct_limbs: int,
              t: Optional[int] = None,
              dnum: Optional[int] = None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Apply a keyswitch key to a coeff-domain poly d (level+1, N).

    Returns (c0_delta, c1_delta) in NTT domain over limbs 0..level — the
    correction pair to add to a ciphertext.  This is the `switch_key` hot path
    (≈20% of a rotation in the reference profile, draw_pie_chart.py:8): per
    digit, one base extension + stacked NTT + dyadic MAC, then mod-down by
    the special primes.

    dnum digits over groups of α limbs; n_special = α special primes occupy
    moduli indices n_ct_limbs .. end.  dnum=None -> per-limb digits.
    """
    L = n_ct_limbs
    n_sp = len(ctx.moduli) - L
    sp_idx = list(range(L, L + n_sp))
    active = level + 1
    dig, used, lim = compute_digits(d_coeff, level, ctx, L, dnum)
    sub_plan = _basis_plan(ctx, lim)
    dig_ntt = negacyclic_ntt(dig, sub_plan)
    lim_idx = jnp.asarray(lim)
    used_idx = jnp.asarray(used)
    kb = ksk.b[used_idx][:, lim_idx]
    ka = ksk.a[used_idx][:, lim_idx]
    q = sub_plan.q_arr[:, None]
    qinv = sub_plan.qinv_arr[:, None]
    t0 = u32.mont_mul(dig_ntt, kb, q, qinv)
    t1 = u32.mont_mul(dig_ntt, ka, q, qinv)
    acc0 = _sum_digits(t0, q)
    acc1 = _sum_digits(t1, q)
    # mod-down by the special primes, last to first (t-aware in BGV); the
    # two accumulators ride one batched drop_limb so the special-limb INTT
    # and the delta NTT are single calls at batch 2 (not 2x batch 1: one
    # launch sequence, and table reads amortize over the batch)
    acc = jnp.stack([acc0, acc1])
    for k_i in range(n_sp - 1, -1, -1):
        keep = list(range(active)) + sp_idx[:k_i]
        acc = drop_limb(acc, sp_idx[k_i], keep, ctx, t)
    return acc[0], acc[1]


def _sum_digits(t: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Tree-sum over the digit axis (axis 0) mod q."""
    while t.shape[0] > 1:
        h = t.shape[0] // 2
        rest = t[2 * h:]
        t = u32.add_mod(t[:h], t[h:2 * h], q)
        if rest.shape[0]:
            t = jnp.concatenate([t, rest], axis=0)
    return t[0]


def _basis_plan(ctx: RnsContext, lim: List[int]):
    """Plan restricted to an arbitrary subset of limbs."""
    return ctx.plan.take(lim)
