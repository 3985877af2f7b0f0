"""BGV scheme layer (L4): batch encoding, encrypt/decrypt, evaluator.

Covers the BGV surface the reference's dot-product campaign consumes
(reliability_test/dotprod_test.cu:67-185: batch encode, asymmetric encrypt,
multiply, relinearize, mod_switch_to_next, rotate rows/columns via Galois
keys, decrypt).

Batching: the plaintext modulus t is an NTT prime ≡ 1 (mod 2n), so slots are
the negacyclic NTT domain mod t, arranged SEAL-style as a 2×(n/2) matrix
(row 0 ↔ exponents 5^j, row 1 ↔ −5^j); rotate_rows cycles within rows,
rotate_columns swaps the rows.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..ops import u32
from ..ops.ntt_pease import (
    PeaseNttPlan, negacyclic_intt, negacyclic_ntt, _galois_perm_nu)
from .keys import (
    KeyGen, KeySwitchKey, PublicKey, SecretKey, keyswitch,
    _rns_from_signed, _sample_gaussian, _sample_ternary,
)
from .params import BgvParams, make_prime_chain
from .rns import RnsContext, RnsPoly, drop_limb, lift_to_limbs, limb_plan, \
    poly_add, poly_automorphism, poly_intt, poly_mul_pointwise, poly_sub
from .ckks import Ciphertext, rns_to_signed


@lru_cache(maxsize=8)
def _slot_map(n: int) -> np.ndarray:
    """map[r, j] = device-NTT slot index holding matrix position (r, j)
    (slot p evaluates at ψ^(2ν(p)+1); ν from the Pease layout)."""
    from rfhe_tpu.ops.ntt_pease import PeaseNttPlan
    from rfhe_tpu import numth
    # ν depends only on n: reuse the cached galois identity computation
    from rfhe_tpu.ops.ntt import bit_reverse_indices
    rho = np.arange(n, dtype=np.int64)
    for s_ in range(n.bit_length() - 1):
        half = (n >> s_) // 2
        va = rho[: n // 2]
        new_rho = np.empty_like(rho)
        new_rho[0::2] = va
        new_rho[1::2] = va + half
        rho = new_rho
    nu = bit_reverse_indices(n)[rho]
    nu_inv = np.empty(n, dtype=np.int64)
    nu_inv[nu] = np.arange(n)
    m = np.empty((2, n // 2), dtype=np.int64)
    for r in range(2):
        g = 1
        for j in range(n // 2):
            e = g if r == 0 else (2 * n - g)
            m[r, j] = nu_inv[(e - 1) // 2]
            g = (g * 5) % (2 * n)
    return m


class BgvContext:
    def __init__(self, params: BgvParams, special_bits: Optional[int] = None,
                 seed: int = 11, dnum: Optional[int] = None):
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
        self.special = sps[0]
        self.ctx = RnsContext.make(n, tuple(params.moduli) + tuple(sps))
        self.L = params.L
        self.t = params.t
        self.plan_t = PeaseNttPlan.make(n, [params.t])
        self.keygen = KeyGen(self.ctx, self.L, params.sigma)
        self.rng = np.random.default_rng(seed)
        self.sk = self.keygen.gen_secret(self.rng)
        self.pk = self._gen_public_bgv()
        self.rlk = self._gen_relin_bgv()
        self._galois: Dict[int, KeySwitchKey] = {}
        # modswitch constants: q_k^{-1} mod t per limb
        self.qk_inv_t = [pow(q, -1, self.t) for q in params.moduli]
        self._crt64_plans = {}
        self._jits = {}

    def _jit(self, name, fn):
        if name not in self._jits:
            from ..utils.jitcache import hoisted_jit
            self._jits[name] = hoisted_jit(fn)
        return self._jits[name]

    # -- BGV-flavored keys (noise scaled by t) ------------------------------
    def _gen_public_bgv(self) -> PublicKey:
        kg, ctx = self.keygen, self.ctx
        L, n = self.L, ctx.n
        moduli = ctx.moduli[:L]
        from .keys import _sample_uniform_rns
        a = jnp.asarray(_sample_uniform_rns(self.rng, moduli, n))
        e = _rns_from_signed(
            self.t * _sample_gaussian(self.rng, n, self.params.sigma), moduli)
        e_ntt = negacyclic_ntt(jnp.asarray(e), ctx.plan.slice(L))
        q = ctx.plan.q_arr[:L, None]
        qinv = ctx.plan.qinv_arr[:L, None]
        b = u32.sub_mod(e_ntt, u32.mont_mul(a, self.sk.s_ntt[:L], q, qinv), q)
        return PublicKey(b=b, a=a)

    def _gen_ks_bgv(self, s_prime_ntt: jnp.ndarray) -> KeySwitchKey:
        """Keyswitch key with t·e noise (so KS noise stays ≡ 0 mod t)."""
        return self.keygen.gen_keyswitch(self.sk, s_prime_ntt, self.rng,
                                         noise_factor=self.t, dnum=self.dnum)

    def _gen_relin_bgv(self) -> KeySwitchKey:
        q = self.ctx.plan.q_arr[:, None]
        qinv = self.ctx.plan.qinv_arr[:, None]
        s2 = u32.mont_mul(self.sk.s_ntt, self.sk.s_ntt, q, qinv)
        return self._gen_ks_bgv(s2)

    def galois_key(self, g: int) -> KeySwitchKey:
        if g not in self._galois:
            perm = jnp.asarray(self.ctx.galois_perm(g))
            self._galois[g] = self._gen_ks_bgv(self.sk.s_ntt[:, perm])
        return self._galois[g]

    # -- batch encode / decode ---------------------------------------------
    def encode(self, matrix: np.ndarray) -> RnsPoly:
        """matrix: (2, n/2) ints mod t -> coeff-domain plaintext RnsPoly."""
        n = self.params.n
        slots = np.zeros(n, dtype=np.uint32)
        m = _slot_map(n)
        slots[m.reshape(-1)] = np.asarray(matrix, dtype=np.uint64).reshape(-1) % self.t
        # to Montgomery domain (device slots are Montgomery), then INTT mod t
        from ..numth import montgomery_constants
        _, qinv_t, r2_t = montgomery_constants(self.t, 32)
        sl = u32.to_mont(jnp.asarray(slots)[None, :], self.t, qinv_t, r2_t)
        coeffs_t = np.asarray(negacyclic_intt(sl, self.plan_t))[0]  # [0, t)
        lifted = np.stack([
            coeffs_t.astype(np.uint64) % q for q in self.params.moduli
        ]).astype(np.uint32)
        return RnsPoly(jnp.asarray(lifted), False)

    def decode(self, coeffs_t: np.ndarray) -> np.ndarray:
        """(n,) coefficients mod t -> (2, n/2) slot matrix."""
        from ..numth import montgomery_constants
        _, qinv_t, _ = montgomery_constants(self.t, 32)
        y = negacyclic_ntt(jnp.asarray(coeffs_t.astype(np.uint32))[None, :],
                           self.plan_t)
        y = np.asarray(u32.from_mont(y, self.t, qinv_t))[0]
        m = _slot_map(self.params.n)
        return y[m]

    # -- encrypt / decrypt --------------------------------------------------
    def encrypt(self, pt: RnsPoly) -> Ciphertext:
        lvl = pt.level
        n = self.params.n
        moduli = self.params.moduli[:lvl + 1]
        plan = self.ctx.plan.slice(lvl + 1)
        u_ = _rns_from_signed(_sample_ternary(self.rng, n), moduli)
        e0 = _rns_from_signed(
            self.t * _sample_gaussian(self.rng, n, self.params.sigma), moduli)
        e1 = _rns_from_signed(
            self.t * _sample_gaussian(self.rng, n, self.params.sigma), moduli)

        def enc(pt_data, u, e0, e1, pkb, pka):
            q = plan.q_arr[:, None]
            qinv = plan.qinv_arr[:, None]
            u_ntt = negacyclic_ntt(u, plan)
            m0_ntt = negacyclic_ntt(u32.add_mod(e0, pt_data, q), plan)
            m1_ntt = negacyclic_ntt(e1, plan)
            c0 = u32.add_mod(u32.mont_mul(pkb, u_ntt, q, qinv), m0_ntt, q)
            c1 = u32.add_mod(u32.mont_mul(pka, u_ntt, q, qinv), m1_ntt, q)
            return c0, c1

        c0, c1 = self._jit(("encrypt", lvl), enc)(
            pt.data, jnp.asarray(u_), jnp.asarray(e0), jnp.asarray(e1),
            self.pk.b[:lvl + 1], self.pk.a[:lvl + 1])
        return Ciphertext([RnsPoly(c0, True), RnsPoly(c1, True)], 1.0)

    def decrypt_coeffs_t(self, ct: Ciphertext, exact: bool = False
                         ) -> np.ndarray:
        """[c(s)]_Q mod t.  Default path reconstructs the small centered
        coefficient m + t·e on-device (ops/crt64.py, exact for noise < 2^45);
        exact=True uses the host object-int CRT."""
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

        corr = ct.correction % self.t
        if exact:
            out = self._jit(("decrypt", ct.size, lvl), dec)(
                [c.data for c in ct.c], self.sk.s_ntt[:lvl + 1])
            signed = rns_to_signed(np.asarray(out),
                                   self.params.moduli[:lvl + 1])
            return ((signed * corr) % self.t).astype(np.uint32)
        from ..ops.crt64 import Crt64Plan, crt_to_words, words_to_signed
        if lvl not in self._crt64_plans:
            self._crt64_plans[lvl] = Crt64Plan.make(
                self.params.moduli[:lvl + 1])
        cplan = self._crt64_plans[lvl]

        def dec64(cs, s):
            return crt_to_words(dec(cs, s), cplan)

        hi, lo = self._jit(("decrypt64", ct.size, lvl), dec64)(
            [c.data for c in ct.c], self.sk.s_ntt[:lvl + 1])
        signed = words_to_signed(np.asarray(hi), np.asarray(lo))
        return ((np.mod(signed, self.t) * corr) % self.t).astype(np.uint32)

    def decrypt_decode(self, ct: Ciphertext) -> np.ndarray:
        return self.decode(self.decrypt_coeffs_t(ct))

    # -- evaluator ----------------------------------------------------------
    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.correction == b.correction
        return Ciphertext(
            [poly_add(x, y, self.ctx) for x, y in zip(a.c, b.c)], 1.0,
            correction=a.correction)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.correction == b.correction
        return Ciphertext(
            [poly_sub(x, y, self.ctx) for x, y in zip(a.c, b.c)], 1.0,
            correction=a.correction)

    def _multiply_impl(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        mul = lambda x, y: poly_mul_pointwise(x, y, self.ctx)
        d0 = mul(a.c[0], b.c[0])
        d1 = poly_add(mul(a.c[0], b.c[1]), mul(a.c[1], b.c[0]), self.ctx)
        d2 = mul(a.c[1], b.c[1])
        return Ciphertext([d0, d1, d2], 1.0,
                          correction=(a.correction * b.correction) % self.t)

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._jit("multiply", self._multiply_impl)(a, b)

    def _relinearize_impl(self, ct: Ciphertext, rlk) -> Ciphertext:
        d2_coeff = poly_intt(ct.c[2], self.ctx)
        k0, k1 = keyswitch(d2_coeff.data, rlk, ct.level, self.ctx,
                           self.L, t=self.t, dnum=self.dnum)
        c0 = poly_add(ct.c[0], RnsPoly(k0, True), self.ctx)
        c1 = poly_add(ct.c[1], RnsPoly(k1, True), self.ctx)
        return Ciphertext([c0, c1], 1.0, correction=ct.correction)

    def relinearize(self, ct: Ciphertext) -> Ciphertext:
        assert ct.size == 3
        return self._jit("relinearize", self._relinearize_impl)(ct, self.rlk)

    def multiply_relin(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self._jit(
            "multiply_relin",
            lambda x, y, k: self._relinearize_impl(self._multiply_impl(x, y), k)
        )(a, b, self.rlk)

    def multiply_plain(self, ct: Ciphertext, pt: RnsPoly) -> Ciphertext:
        from .rns import poly_ntt
        pt_ntt = poly_ntt(RnsPoly(pt.data[:ct.level + 1], False), self.ctx) \
            if not pt.is_ntt else pt
        return Ciphertext(
            [poly_mul_pointwise(c, pt_ntt, self.ctx) for c in ct.c], 1.0,
            correction=ct.correction)

    def mod_switch_to_next(self, ct: Ciphertext) -> Ciphertext:
        return self._jit("mod_switch", self._mod_switch_impl)(ct)

    def _mod_switch_impl(self, ct: Ciphertext) -> Ciphertext:
        """BGV modulus switch: divide by the top prime q_k while keeping the
        message mod t: c' = (c − δ)/q_k with δ ≡ c (mod q_k), δ ≡ 0 (mod t),
        δ centered (dotprod_test.cu:115 mod_switch_to_next_inplace)."""
        k = ct.level
        qk = self.params.moduli[k]
        qk_inv_t = pow(qk, -1, self.t)
        out_polys = []
        from ..numth import barrett_constants
        mu_t, k_t = barrett_constants(self.t)
        for p in ct.c:
            # top limb to coeff domain
            top = negacyclic_intt(p.data[k:k + 1], limb_plan(self.ctx, k))[0]
            half = qk // 2
            over = top > half                     # centered lift flag
            # r = [top_c * qk^{-1}]_t = [top·qk^{-1} − over]_t
            # (top < 2^31, qk_inv_t < t < 2^31: product fits the u64 pair)
            hi, lo = u32.mul32_parts(top, jnp.uint32(qk_inv_t % (1 << 32)))
            r = u32.barrett_reduce64(hi, lo, self.t, mu_t, k_t)
            r = jnp.where(over, u32.sub_mod(r, jnp.uint32(1), self.t), r)
            r_over = r > (self.t // 2)
            # delta_i = [top]_centered − q_k·r_centered per limb i
            rows = []
            zeros = jnp.zeros_like(top)
            for i in range(k):
                qi = self.params.moduli[i]
                v = top if qk <= qi else u32.barrett_reduce64(
                    zeros, top, qi, self.ctx.barrett_mu[i],
                    self.ctx.barrett_k[i])
                v = jnp.where(over, u32.sub_mod(
                    v, self.ctx.qk_mod[k][i], qi), v)
                # subtract qk·r (centered r) mod qi
                r_i = r if self.t <= qi else r  # t < qi always here
                r_c = jnp.where(r_over, u32.sub_mod(
                    r_i, jnp.uint32(self.t % qi), qi), r_i)
                qk_r = u32.mul_mod(jnp.uint32(qk % qi), r_c, qi,
                                   _qinv(qi), _r2(qi))
                rows.append(u32.sub_mod(v, qk_r, qi))
            delta = jnp.stack(rows)
            delta_ntt = negacyclic_ntt(delta, self.ctx.plan.slice(k))
            q_lo = self.ctx.plan.q_arr[:k, None]
            num = u32.sub_mod(p.data[:k], delta_ntt, q_lo)
            outd = u32.mul_mod_shoup(num, self.ctx.qk_inv[k][:k, None],
                                     self.ctx.qk_inv_shoup[k][:k, None], q_lo)
            out_polys.append(RnsPoly(outd, True))
        # message scaled by qk^{-1} (mod t): decryption must multiply by qk
        return Ciphertext(out_polys, 1.0,
                          correction=(ct.correction * qk) % self.t)

    def _apply_galois_impl(self, ct: Ciphertext, ksk, g: int) -> Ciphertext:
        c0g = poly_automorphism(ct.c[0], g, self.ctx)
        c1g = poly_automorphism(ct.c[1], g, self.ctx)
        c1_coeff = poly_intt(c1g, self.ctx)
        k0, k1 = keyswitch(c1_coeff.data, ksk, ct.level,
                           self.ctx, self.L, t=self.t, dnum=self.dnum)
        c0 = poly_add(c0g, RnsPoly(k0, True), self.ctx)
        return Ciphertext([c0, RnsPoly(k1, True)], 1.0,
                          correction=ct.correction)

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


@lru_cache(maxsize=64)
def _qinv(q: int) -> int:
    from ..numth import montgomery_constants
    return montgomery_constants(q, 32)[1]


@lru_cache(maxsize=64)
def _r2(q: int) -> int:
    from ..numth import montgomery_constants
    return montgomery_constants(q, 32)[2]
