"""BFV scheme layer (L4): scale-invariant FV with a full-RNS (BEHZ-style)
multiply, vectorized over stacked limbs.

Covers the BFV surface the reference times in its perf framework
(profile_framewk/src/framewk.cpp:14-397 `bfv_performance_test`: batch
encode/decode, encrypt/decrypt, add, multiply, square, relinearize,
multiply_plain, rotate rows/columns/conjugate) and the BFV rotate-fold path
of the dot-product profile (profile_framewk/src/dotprod_bfv.cpp:48-65).

Design (not a translation): the two base extensions and the final Shenoy-
Kumaresan conversion of the BEHZ multiply are each ONE int8-digit matmul
(ops/baseconv.py) over pre-scaled residues |x·Q̂_j^{-1}|_{q_j}, so conversion
overflow stays < k and the m̃ / m_sk corrections are exact; everything else
is elementwise u32 modular arithmetic on stacked (limb, coeff) arrays.  The
whole multiply (extend → tensor in Q∪Bsk → ⌊t·d/Q⌋ → convert back) is one
jitted program; all three tensor components ride a leading batch axis.

Plaintext batching is the same negacyclic-NTT slot structure as BGV
(t ≡ 1 mod 2n; SEAL-style 2×(n/2) matrix, rows = ±5^j orbits).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..numth import is_prime, mod_inv, shoup_precompute
from ..ops import u32
from ..ops.baseconv import BaseConvPlan, base_conv
from ..ops.ntt_pease import PeaseNttPlan, negacyclic_intt, negacyclic_ntt
from .bgv import _slot_map
from .ckks import Ciphertext, rns_to_signed
from .keys import (
    KeyGen, KeySwitchKey, PublicKey, SecretKey, keyswitch,
    _rns_from_signed, _sample_gaussian, _sample_ternary,
)
from .params import BfvParams, make_prime_chain
from .rns import RnsContext, RnsPoly, poly_add, poly_automorphism, \
    poly_intt, poly_mul_pointwise, poly_ntt, poly_sub


def _shoup_arr(vals: List[int], mods: List[int]):
    """(w, w_shoup) device arrays for per-limb Shoup constant multiplies."""
    w = np.array(vals, dtype=np.uint32)
    ws = np.array([shoup_precompute(int(v), int(q)) for v, q in zip(vals, mods)],
                  dtype=np.uint32)
    return jnp.asarray(w), jnp.asarray(ws)


@dataclass(frozen=True)
class BehzPlan:
    """Static tables for the full-RNS BFV multiply at one level (k data limbs).

    Bases: Q = q_0..q_{k-1} (data), B = b_1..b_{k+2}, Bsk = B ∪ {m_sk},
    m̃ ≈ 2^16 (correction-only channel, never NTT'd).
    """
    k: int
    moduli: Tuple[int, ...]            # Q primes
    bsk: Tuple[int, ...]               # B primes + m_sk (all NTT primes)
    mtilde: int
    bsk_plan: PeaseNttPlan
    # extend: y_j = |x · m̃·Q̂_j^{-1}|_{q_j}, conv by W1[j,c] = Q̂_j mod c
    ext_mul: Tuple[jnp.ndarray, jnp.ndarray]         # (k,) m̃·Q̂_j^{-1} mod q_j
    conv_q_to_bskm: BaseConvPlan                     # Q -> Bsk ∪ {m̃}
    neg_qinv_mt: Tuple[jnp.ndarray, jnp.ndarray]     # (−Q)^{-1} mod m̃ (scalar)
    q_mod_bsk: Tuple[jnp.ndarray, jnp.ndarray]       # (kb,)
    qmt_mod_bsk: Tuple[jnp.ndarray, jnp.ndarray]     # (kb,) Q·m̃ mod b
    mt_inv_bsk: Tuple[jnp.ndarray, jnp.ndarray]      # (kb,) m̃^{-1} mod b
    # floor: u_j = |t·d · Q̂_j^{-1}|_{q_j}; w = (t·d − conv)·Q^{-1} in Bsk
    t_mod_q: Tuple[jnp.ndarray, jnp.ndarray]         # (k,)
    t_mod_bsk: Tuple[jnp.ndarray, jnp.ndarray]       # (kb,)
    qhat_inv: Tuple[jnp.ndarray, jnp.ndarray]        # (k,) Q̂_j^{-1} mod q_j
    q_inv_bsk: Tuple[jnp.ndarray, jnp.ndarray]       # (kb,) Q^{-1} mod b
    # Shenoy–Kumaresan exact conversion B -> Q using m_sk
    bhat_inv: Tuple[jnp.ndarray, jnp.ndarray]        # (kb-1,) B̂_i^{-1} mod b_i
    conv_b_to_qmsk: BaseConvPlan                     # B -> Q ∪ {m_sk}
    b_inv_msk: Tuple[jnp.ndarray, jnp.ndarray]       # B^{-1} mod m_sk (scalar)
    b_mod_q: Tuple[jnp.ndarray, jnp.ndarray]         # (k,)
    bmsk_mod_q: Tuple[jnp.ndarray, jnp.ndarray]      # (k,) B·m_sk mod q

    @classmethod
    def make(cls, n: int, moduli: Tuple[int, ...], t: int,
             avoid: Tuple[int, ...]) -> "BehzPlan":
        from ..numth import find_ntt_primes
        k = len(moduli)
        Q = math.prod(moduli)
        taken = set(moduli) | set(avoid) | {t}
        pool = [p for p in find_ntt_primes(n, 30, k + 3 + len(taken))
                if p not in taken]
        bsk = tuple(pool[: k + 3])               # k+2 B primes + m_sk
        B_primes, msk = bsk[:-1], bsk[-1]
        B = math.prod(B_primes)
        mt = 65537
        while mt in taken or mt in bsk or not is_prime(mt):
            mt += 2
        kb = len(bsk)
        qhat = [Q // q for q in moduli]
        W1 = np.array([[qhat[j] % c for c in bsk + (mt,)] for j in range(k)],
                      dtype=np.uint64)
        bhat = [B // b for b in B_primes]
        W2 = np.array([[bhat[i] % c for c in moduli + (msk,)]
                       for i in range(kb - 1)], dtype=np.uint64)
        modl = list(moduli)
        bskl = list(bsk)
        return cls(
            k=k, moduli=moduli, bsk=bsk, mtilde=mt,
            bsk_plan=PeaseNttPlan.make(n, bsk),
            ext_mul=_shoup_arr([(mt * mod_inv(qhat[j] % q, q)) % q
                                for j, q in enumerate(moduli)], modl),
            conv_q_to_bskm=BaseConvPlan.from_matrix(W1, moduli, bsk + (mt,)),
            neg_qinv_mt=_shoup_arr([mod_inv((-Q) % mt, mt)], [mt]),
            q_mod_bsk=_shoup_arr([Q % b for b in bsk], bskl),
            qmt_mod_bsk=_shoup_arr([(Q * mt) % b for b in bsk], bskl),
            mt_inv_bsk=_shoup_arr([mod_inv(mt % b, b) for b in bsk], bskl),
            t_mod_q=_shoup_arr([t % q for q in moduli], modl),
            t_mod_bsk=_shoup_arr([t % b for b in bsk], bskl),
            qhat_inv=_shoup_arr([mod_inv(qhat[j] % q, q)
                                 for j, q in enumerate(moduli)], modl),
            q_inv_bsk=_shoup_arr([mod_inv(Q % b, b) for b in bsk], bskl),
            bhat_inv=_shoup_arr([mod_inv(bhat[i] % b, b)
                                 for i, b in enumerate(B_primes)],
                                list(B_primes)),
            conv_b_to_qmsk=BaseConvPlan.from_matrix(W2, B_primes,
                                                    moduli + (msk,)),
            b_inv_msk=_shoup_arr([mod_inv(B % msk, msk)], [msk]),
            b_mod_q=_shoup_arr([B % q for q in moduli], modl),
            bmsk_mod_q=_shoup_arr([(B * msk) % q for q in moduli], modl),
        )

    # ---- device-side stages (all shapes (..., limbs, n)) -------------------

    def extend_to_bsk(self, x: jnp.ndarray, q_arr: jnp.ndarray) -> jnp.ndarray:
        """Coeff-domain x (.., k, n) mod Q -> representative mod Bsk (.., kb, n)
        equal to x + u·Q, u ∈ {0,±1} (BEHZ small-Montgomery correction)."""
        mt = self.mtilde
        w, ws = self.ext_mul
        y = u32.mul_mod_shoup(x, w[:, None], ws[:, None], q_arr[:, None])
        conv = base_conv(y, self.conv_q_to_bskm)         # (.., kb+1, n)
        xb, xm = conv[..., :-1, :], conv[..., -1, :]
        nw, nws = self.neg_qinv_mt
        r = u32.mul_mod_shoup(xm, nw[0], nws[0], mt)     # |−x·Q^{-1}|_m̃
        qb = self.bsk_arr
        qw, qws = self.q_mod_bsk
        v = u32.add_mod(
            xb, u32.mul_mod_shoup(r[..., None, :], qw[:, None], qws[:, None],
                                  qb[:, None]), qb[:, None])
        qmw, _ = self.qmt_mod_bsk
        corr = jnp.where(r[..., None, :] > mt // 2, qmw[:, None],
                         jnp.uint32(0))
        v = u32.sub_mod(v, corr, qb[:, None])
        mw, mws = self.mt_inv_bsk
        return u32.mul_mod_shoup(v, mw[:, None], mws[:, None], qb[:, None])

    def rns_floor(self, td_q: jnp.ndarray, td_bsk: jnp.ndarray,
                  q_arr: jnp.ndarray) -> jnp.ndarray:
        """⌊t·d/Q⌋ (+err < k) in Bsk, from t·d residues in Q and Bsk."""
        w, ws = self.qhat_inv
        u = u32.mul_mod_shoup(td_q, w[:, None], ws[:, None], q_arr[:, None])
        conv = base_conv(u, self.conv_q_to_bskm)[..., :-1, :]
        qb = self.bsk_arr
        iw, iws = self.q_inv_bsk
        return u32.mul_mod_shoup(u32.sub_mod(td_bsk, conv, qb[:, None]),
                                 iw[:, None], iws[:, None], qb[:, None])

    def conv_sk(self, w: jnp.ndarray, q_arr: jnp.ndarray) -> jnp.ndarray:
        """Exact Shenoy–Kumaresan conversion Bsk -> Q (m_sk corrects the
        B-overflow; plays the role of baseConv.cu's exact Garner path)."""
        msk = int(self.bsk[-1])
        bw, bws = self.bhat_inv
        qb_B = self.bsk_arr[:-1]
        v = u32.mul_mod_shoup(w[..., :-1, :], bw[:, None], bws[:, None],
                              qb_B[:, None])
        conv = base_conv(v, self.conv_b_to_qmsk)         # (.., k+1, n)
        cq, cmsk = conv[..., :-1, :], conv[..., -1, :]
        iw, iws = self.b_inv_msk
        alpha = u32.mul_mod_shoup(
            u32.sub_mod(cmsk, w[..., -1, :], msk), iw[0], iws[0], msk)
        bm, bms = self.b_mod_q
        out = u32.sub_mod(
            cq, u32.mul_mod_shoup(alpha[..., None, :], bm[:, None],
                                  bms[:, None], q_arr[:, None]),
            q_arr[:, None])
        bmm, _ = self.bmsk_mod_q
        corr = jnp.where(alpha[..., None, :] > msk // 2, bmm[:, None],
                         jnp.uint32(0))
        return u32.add_mod(out, corr, q_arr[:, None])

    @property
    def bsk_arr(self) -> jnp.ndarray:
        return self.bsk_plan.q_arr


@dataclass(frozen=True)
class GammaDecryptPlan:
    """BEHZ γ-correction decrypt tables: m = ⌊t·x/Q⌉ mod t recovered exactly
    on-device.  With t·x = Q·m + v (|v| ≪ Q/2) and γ coprime:
        s_{t,γ} = |FastBConv(|γ·t·x|_Q) · (−Q^{-1})|_{t,γ} = γ·m + r − e
    (r = ⌊γ·v/Q⌉, e < k the conversion overflow), so centering s_γ recovers
    r − e and m = (s_t − [s_γ]_c)·γ^{-1} mod t.  Needs γ > 4(k+1)."""
    gamma: int
    t: int
    w: Tuple[jnp.ndarray, jnp.ndarray]       # (k,) |γ·t·Q̂_j^{-1}|_{q_j}
    conv: BaseConvPlan                       # Q -> (t, γ)
    neg_qinv: Tuple[jnp.ndarray, jnp.ndarray]  # (2,) −Q^{-1} mod (t, γ)
    gamma_mod_t: int
    gamma_inv_t: Tuple[jnp.ndarray, jnp.ndarray]  # scalar

    @classmethod
    def make(cls, moduli: Tuple[int, ...], t: int) -> "GammaDecryptPlan":
        k = len(moduli)
        gamma = 257
        while gamma in moduli or gamma == t or not is_prime(gamma) \
                or gamma <= 4 * (k + 1):
            gamma += 2
        Q = math.prod(moduli)
        qhat = [Q // q for q in moduli]
        W = np.array([[qhat[j] % c for c in (t, gamma)] for j in range(k)],
                     dtype=np.uint64)
        return cls(
            gamma=gamma, t=t,
            w=_shoup_arr([(gamma * t * mod_inv(qhat[j] % q, q)) % q
                          for j, q in enumerate(moduli)], list(moduli)),
            conv=BaseConvPlan.from_matrix(W, moduli, (t, gamma)),
            neg_qinv=_shoup_arr([(-mod_inv(Q % c, c)) % c
                                 for c in (t, gamma)], [t, gamma]),
            gamma_mod_t=gamma % t,
            gamma_inv_t=_shoup_arr([mod_inv(gamma % t, t)], [t]),
        )

    def decrypt_mod_t(self, x: jnp.ndarray, q_arr: jnp.ndarray) -> jnp.ndarray:
        """x: (k, n) coeff-domain residues of [c(s)]_Q -> (n,) m mod t."""
        w, ws = self.w
        y = u32.mul_mod_shoup(x, w[:, None], ws[:, None], q_arr[:, None])
        conv = base_conv(y, self.conv)                   # (2, n): mod t, γ
        nw, nws = self.neg_qinv
        tg = jnp.asarray(np.array([self.t, self.gamma], dtype=np.uint32))
        s = u32.mul_mod_shoup(conv, nw[:, None], nws[:, None], tg[:, None])
        s_t, s_g = s[0], s[1]
        ind = s_g > self.gamma // 2
        d = u32.sub_mod(s_t, s_g, self.t)                # s_γ < γ < t
        d = u32.add_mod(
            d, jnp.where(ind, jnp.uint32(self.gamma_mod_t), jnp.uint32(0)),
            self.t)
        gw, gws = self.gamma_inv_t
        return u32.mul_mod_shoup(d, gw[0], gws[0], self.t)


class BfvContext:
    """BFV context: keys, batching, evaluator (SEAL-surface parity —
    profile_framewk/src/framewk.cpp bfv_performance_test)."""

    def __init__(self, params: BfvParams, special_bits: Optional[int] = None,
                 seed: int = 13, dnum: Optional[int] = None):
        self.params = params
        n = params.n
        if special_bits is None:
            # 30-bit specials at n=65536: inherited policy, kept so chains
            # do not change (see CkksContext.__init__)
            special_bits = 30 if n >= 65536 else 31
        self.dnum = dnum
        n_sp = 1 if dnum is None else -(-params.L // dnum)
        sps = [p for p in make_prime_chain(n, [special_bits] * (n_sp + 2))
               if p not in params.moduli and p != params.t][:n_sp]
        assert len(sps) == n_sp
        self.ctx = RnsContext.make(n, tuple(params.moduli) + tuple(sps))
        self.L = params.L
        self.t = params.t
        self.plan_t = PeaseNttPlan.make(n, [params.t])
        self.keygen = KeyGen(self.ctx, self.L, params.sigma)
        self.rng = np.random.default_rng(seed)
        self.sk = self.keygen.gen_secret(self.rng)
        self.pk = self.keygen.gen_public(self.sk, self.rng)
        self.rlk = self.keygen.gen_relin(self.sk, self.rng) if dnum is None \
            else self.keygen.gen_keyswitch(
                self.sk, self._s2_ntt(), self.rng, dnum=dnum)
        self._galois: Dict[int, KeySwitchKey] = {}
        self._behz: Dict[int, BehzPlan] = {}
        self._gamma_plans: Dict[int, GammaDecryptPlan] = {}
        self._jits = {}

    def _s2_ntt(self):
        q = self.ctx.plan.q_arr[:, None]
        qinv = self.ctx.plan.qinv_arr[:, None]
        return u32.mont_mul(self.sk.s_ntt, self.sk.s_ntt, q, qinv)

    def _jit(self, name, fn):
        if name not in self._jits:
            from ..utils.jitcache import hoisted_jit
            self._jits[name] = hoisted_jit(fn)
        return self._jits[name]

    def behz(self, level: int) -> BehzPlan:
        if level not in self._behz:
            self._behz[level] = BehzPlan.make(
                self.params.n, self.params.moduli[: level + 1], self.t,
                avoid=self.ctx.moduli)
        return self._behz[level]

    def galois_key(self, g: int) -> KeySwitchKey:
        if g not in self._galois:
            perm = jnp.asarray(self.ctx.galois_perm(g))
            self._galois[g] = self.keygen.gen_keyswitch(
                self.sk, self.sk.s_ntt[:, perm], self.rng, dnum=self.dnum)
        return self._galois[g]

    # -- batch encode / decode (same slot structure as BGV) -----------------
    def encode(self, matrix: np.ndarray) -> np.ndarray:
        """(2, n/2) ints mod t -> coeff-domain plaintext (n,) uint32 mod t."""
        n = self.params.n
        slots = np.zeros(n, dtype=np.uint32)
        m = _slot_map(n)
        slots[m.reshape(-1)] = \
            np.asarray(matrix, dtype=np.uint64).reshape(-1) % self.t
        from ..numth import montgomery_constants
        _, qinv_t, r2_t = montgomery_constants(self.t, 32)
        sl = u32.to_mont(jnp.asarray(slots)[None, :], self.t, qinv_t, r2_t)
        return np.asarray(negacyclic_intt(sl, self.plan_t))[0]

    def decode(self, coeffs_t: np.ndarray) -> np.ndarray:
        from ..numth import montgomery_constants
        _, qinv_t, _ = montgomery_constants(self.t, 32)
        y = negacyclic_ntt(jnp.asarray(coeffs_t.astype(np.uint32))[None, :],
                           self.plan_t)
        y = np.asarray(u32.from_mont(y, self.t, qinv_t))[0]
        return y[_slot_map(self.params.n)]

    # -- encrypt / decrypt ----------------------------------------------------
    def _delta_mont(self, level: int):
        """Δ = ⌊Q_level/t⌋ in per-limb Shoup form."""
        mods = list(self.params.moduli[: level + 1])
        delta = math.prod(mods) // self.t
        return _shoup_arr([delta % q for q in mods], mods)

    def encrypt(self, pt_coeffs_t: np.ndarray, level: Optional[int] = None
                ) -> Ciphertext:
        lvl = self.L - 1 if level is None else level
        n = self.params.n
        moduli = self.params.moduli[: lvl + 1]
        plan = self.ctx.plan.slice(lvl + 1)
        dw, dws = self._delta_mont(lvl)
        u_ = _rns_from_signed(_sample_ternary(self.rng, n), moduli)
        e0 = _rns_from_signed(
            _sample_gaussian(self.rng, n, self.params.sigma), moduli)
        e1 = _rns_from_signed(
            _sample_gaussian(self.rng, n, self.params.sigma), moduli)
        m = jnp.asarray(pt_coeffs_t.astype(np.uint32))

        def enc(m, u, e0, e1, pkb, pka):
            q = plan.q_arr[:, None]
            qinv = plan.qinv_arr[:, None]
            dm = u32.mul_mod_shoup(m[None, :], dw[:, None], dws[:, None], q)
            u_ntt = negacyclic_ntt(u, plan)
            m0_ntt = negacyclic_ntt(u32.add_mod(e0, dm, q), plan)
            m1_ntt = negacyclic_ntt(e1, plan)
            c0 = u32.add_mod(u32.mont_mul(pkb, u_ntt, q, qinv), m0_ntt, q)
            c1 = u32.add_mod(u32.mont_mul(pka, u_ntt, q, qinv), m1_ntt, q)
            return c0, c1

        c0, c1 = self._jit(("encrypt", lvl), enc)(
            m, jnp.asarray(u_), jnp.asarray(e0), jnp.asarray(e1),
            self.pk.b[: lvl + 1], self.pk.a[: lvl + 1])
        return Ciphertext([RnsPoly(c0, True), RnsPoly(c1, True)], 1.0)

    def decrypt_coeffs_t(self, ct: Ciphertext, exact: bool = False
                         ) -> np.ndarray:
        """m = ⌊t·[c(s)]_Q/Q⌉ mod t.  Default: fully on-device BEHZ
        γ-correction (GammaDecryptPlan); exact=True: host CRT rounding."""
        lvl = ct.level
        plan = self.ctx.plan.slice(lvl + 1)

        def dec(cs, s):
            q = plan.q_arr[:, None]
            qinv = plan.qinv_arr[:, None]
            acc = cs[0]
            spow = s
            for comp in cs[1:]:
                acc = u32.add_mod(acc, u32.mont_mul(comp, spow, q, qinv), q)
                spow = u32.mont_mul(spow, s, q, qinv)
            return negacyclic_intt(acc, plan)

        if exact:
            out = self._jit(("decrypt", ct.size, lvl), dec)(
                [c.data for c in ct.c], self.sk.s_ntt[: lvl + 1])
            moduli = [int(q) for q in self.params.moduli[: lvl + 1]]
            Q = math.prod(moduli)
            x = rns_to_signed(np.asarray(out), moduli)   # centered object ints
            t = self.t
            m = (x * t * 2 + Q) // (2 * Q)               # round(t·x/Q)
            return (m % t).astype(np.uint32)
        if lvl not in self._gamma_plans:
            self._gamma_plans[lvl] = GammaDecryptPlan.make(
                self.params.moduli[: lvl + 1], self.t)
        gp = self._gamma_plans[lvl]

        def dec_g(cs, s):
            return gp.decrypt_mod_t(dec(cs, s), plan.q_arr)

        out = self._jit(("decrypt_g", ct.size, lvl), dec_g)(
            [c.data for c in ct.c], self.sk.s_ntt[: lvl + 1])
        return np.asarray(out)

    def decrypt_decode(self, ct: Ciphertext) -> np.ndarray:
        return self.decode(self.decrypt_coeffs_t(ct))

    # -- evaluator -------------------------------------------------------------
    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return Ciphertext(
            [poly_add(x, y, self.ctx) for x, y in zip(a.c, b.c)], 1.0)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return Ciphertext(
            [poly_sub(x, y, self.ctx) for x, y in zip(a.c, b.c)], 1.0)

    def _multiply_impl(self, a0, a1, b0, b1, bp: BehzPlan, plan):
        """Full BEHZ multiply; inputs NTT-domain (k, n) mod Q, returns three
        NTT-domain components of ⌊t/Q · (ct_a ⊗ ct_b)⌉ mod Q."""
        q = plan.q_arr
        # tensor in Q (already NTT); batch the three components
        qb, qinv = q[:, None], plan.qinv_arr[:, None]
        d0 = u32.mont_mul(a0, b0, qb, qinv)
        d1 = u32.add_mod(u32.mont_mul(a0, b1, qb, qinv),
                         u32.mont_mul(a1, b0, qb, qinv), qb)
        d2 = u32.mont_mul(a1, b1, qb, qinv)
        d_q = jnp.stack([d0, d1, d2])                    # (3, k, n) NTT
        # extend inputs to Bsk and tensor there
        comps = jnp.stack([a0, a1, b0, b1])              # (4, k, n) NTT
        coeff = negacyclic_intt(comps, plan)
        ext = bp.extend_to_bsk(coeff, q)                 # (4, kb, n) coeff
        en = negacyclic_ntt(ext, bp.bsk_plan)
        bq, binv = bp.bsk_arr[:, None], bp.bsk_plan.qinv_arr[:, None]
        e0 = u32.mont_mul(en[0], en[2], bq, binv)
        e1 = u32.add_mod(u32.mont_mul(en[0], en[3], bq, binv),
                         u32.mont_mul(en[1], en[2], bq, binv), bq)
        e2 = u32.mont_mul(en[1], en[3], bq, binv)
        d_bsk = jnp.stack([e0, e1, e2])                  # (3, kb, n) NTT
        # coeff domain, scale by t
        dq_c = negacyclic_intt(d_q, plan)
        db_c = negacyclic_intt(d_bsk, bp.bsk_plan)
        tw, tws = bp.t_mod_q
        td_q = u32.mul_mod_shoup(dq_c, tw[:, None], tws[:, None], qb)
        tbw, tbws = bp.t_mod_bsk
        td_b = u32.mul_mod_shoup(db_c, tbw[:, None], tbws[:, None], bq)
        # ⌊t·d/Q⌋ in Bsk, then exact conversion back to Q
        w = bp.rns_floor(td_q, td_b, q)
        out = bp.conv_sk(w, q)                           # (3, k, n) coeff
        return negacyclic_ntt(out, plan)

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.size == 2 and b.size == 2 and a.level == b.level
        lvl = a.level
        bp = self.behz(lvl)
        plan = self.ctx.plan.slice(lvl + 1)
        out = self._jit(("multiply", lvl),
                        lambda a0, a1, b0, b1: self._multiply_impl(
                            a0, a1, b0, b1, bp, plan))(
            a.c[0].data, a.c[1].data, b.c[0].data, b.c[1].data)
        return Ciphertext([RnsPoly(out[i], True) for i in range(3)], 1.0)

    def square(self, a: Ciphertext) -> Ciphertext:
        return self.multiply(a, a)

    def _relinearize_impl(self, ct: Ciphertext, rlk) -> Ciphertext:
        d2_coeff = poly_intt(ct.c[2], self.ctx)
        k0, k1 = keyswitch(d2_coeff.data, rlk, ct.level, self.ctx,
                           self.L, dnum=self.dnum)
        c0 = poly_add(ct.c[0], RnsPoly(k0, True), self.ctx)
        c1 = poly_add(ct.c[1], RnsPoly(k1, True), self.ctx)
        return Ciphertext([c0, c1], 1.0)

    def relinearize(self, ct: Ciphertext) -> Ciphertext:
        assert ct.size == 3
        return self._jit("relinearize", self._relinearize_impl)(ct, self.rlk)

    def multiply_relin(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self.relinearize(self.multiply(a, b))

    def multiply_plain(self, ct: Ciphertext, pt_coeffs_t: np.ndarray
                       ) -> Ciphertext:
        """ct · pt with pt an unscaled batch plaintext (coefficients mod t)."""
        lifted = np.stack([pt_coeffs_t.astype(np.uint64) % q
                           for q in self.params.moduli[: ct.level + 1]]
                          ).astype(np.uint32)
        pt_ntt = poly_ntt(RnsPoly(jnp.asarray(lifted), False), self.ctx)
        return Ciphertext(
            [poly_mul_pointwise(c, pt_ntt, self.ctx) for c in ct.c], 1.0)

    def _apply_galois_impl(self, ct: Ciphertext, ksk, g: int) -> Ciphertext:
        c0g = poly_automorphism(ct.c[0], g, self.ctx)
        c1g = poly_automorphism(ct.c[1], g, self.ctx)
        c1_coeff = poly_intt(c1g, self.ctx)
        k0, k1 = keyswitch(c1_coeff.data, ksk, ct.level,
                           self.ctx, self.L, dnum=self.dnum)
        c0 = poly_add(c0g, RnsPoly(k0, True), self.ctx)
        return Ciphertext([c0, RnsPoly(k1, True)], 1.0)

    def apply_galois(self, ct: Ciphertext, g: int) -> Ciphertext:
        assert ct.size == 2
        ksk = self.galois_key(g)
        return self._jit(("galois", g),
                         lambda c, k: self._apply_galois_impl(c, k, g))(ct, ksk)

    def rotate_rows(self, ct: Ciphertext, r: int) -> Ciphertext:
        n = self.params.n
        return self.apply_galois(ct, pow(5, r % (n // 2), 2 * n))

    def rotate_columns(self, ct: Ciphertext) -> Ciphertext:
        return self.apply_galois(ct, 2 * self.params.n - 1)
