"""CKKS scheme layer (L4): encode/decode, encrypt/decrypt, evaluator.

Covers the SEAL/Phantom surface the reference consumes (SURVEY.md §2.5 item
6-7): add, multiply (+relinearize), rescale, mod-switch, rotate/conjugate via
Galois keys — the ops whose cost profile defines the paper's baselines
(rotation = NTT 61% + switch_key 20%..., BASELINE.md).

Encode/decode run on host in float64 (canonical embedding, exact O(n^2)
evaluation — test-grade); everything after encode is exact integer RNS
arithmetic on device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..ops import u32
from .keys import KeyGen, KeySwitchKey, PublicKey, SecretKey, keyswitch
from .params import CkksParams, make_prime_chain
from .rns import (
    RnsContext, RnsPoly, poly_add, poly_automorphism, poly_intt,
    poly_mul_pointwise, poly_ntt, poly_sub, rescale,
)


# ---------------------------------------------------------------------------
# host-side canonical embedding (test-grade O(n^2), float64)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def _slot_exponents(n: int) -> np.ndarray:
    """k_j = 5^j mod 2n for j < n/2: the exponent of the primitive 2n-th root
    at which slot j evaluates."""
    ks = np.empty(n // 2, dtype=np.int64)
    k = 1
    for j in range(n // 2):
        ks[j] = k
        k = (k * 5) % (2 * n)
    return ks


def encode(z: np.ndarray, n: int, scale: float, moduli) -> np.ndarray:
    """Complex slots (n/2,) -> (L, N) uint32 RNS coefficients.

    FFT-based canonical embedding, O(n log n): place z_j at odd exponent
    k_j = 5^j (conjugate at 2n−k_j), then
      a_t = (1/n)·Re( e^{-iπt/n} · FFT(g)[t] ),  g_m = f(2m+1).
    """
    z = np.asarray(z, dtype=np.complex128)
    assert z.shape == (n // 2,)
    ks = _slot_exponents(n)
    g = np.zeros(n, dtype=np.complex128)
    g[(ks - 1) // 2] = z
    g[(2 * n - ks - 1) // 2] = np.conj(z)
    t = np.arange(n)
    twist = np.exp(-1j * np.pi * t / n)
    a = np.real(twist * np.fft.fft(g)) / n * scale
    coeffs = np.round(a).astype(np.int64)
    return np.stack([
        np.mod(coeffs, q).astype(np.uint32) for q in moduli
    ])


def decode(coeffs_signed: np.ndarray, n: int, scale: float) -> np.ndarray:
    """Signed integer coefficients (N,) -> complex slots (n/2,), O(n log n):
    z_j = F(k_j) with F(2m+1) = n·IFFT(a ⊙ e^{iπt/n})[m]."""
    ks = _slot_exponents(n)
    a = coeffs_signed.astype(np.float64)
    t = np.arange(n)
    twist = np.exp(1j * np.pi * t / n)
    F = n * np.fft.ifft(a * twist)
    return F[(ks - 1) // 2] / scale


def rns_to_signed(data: np.ndarray, moduli) -> np.ndarray:
    """CRT-reconstruct (L, N) residues to centered Python-int coefficients
    (vectorized object-dtype arithmetic: ~100x the per-element loop)."""
    from ..numth import crt_constants
    moduli = [int(q) for q in moduli]
    P, hat_p, inv_hat_p = crt_constants(moduli)
    weights = [(hat_p[j] * inv_hat_p[j]) % P for j in range(len(moduli))]
    acc = np.zeros(data.shape[1], dtype=object)
    for j in range(len(moduli)):
        acc += data[j].astype(object) * weights[j]
    acc %= P
    return np.where(acc > P // 2, acc - P, acc)


# ---------------------------------------------------------------------------
# context & ciphertext
# ---------------------------------------------------------------------------

import jax


@jax.tree_util.register_pytree_node_class
@dataclass
class Ciphertext:
    c: List[RnsPoly]          # 2 (or 3 before relinearization), NTT domain
    scale: float
    # BGV only: multiplier to apply at decryption (mod t), accumulated by
    # mod-switching (message scales by q_k^{-1} mod t per switch)
    correction: int = 1

    def tree_flatten(self):
        # scale/correction are trace-time metadata (determined by the op
        # sequence), so whole homomorphic pipelines jit over Ciphertexts
        return (self.c,), (self.scale, self.correction)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(c=list(children[0]), scale=aux[0], correction=aux[1])

    @property
    def level(self) -> int:
        return self.c[0].level

    @property
    def size(self) -> int:
        return len(self.c)


class CkksContext:
    """Bundles parameters, RNS tables (ciphertext primes + special prime),
    and key material."""

    def __init__(self, params: CkksParams, special_bits: Optional[int] = None,
                 seed: int = 7, dnum: Optional[int] = None):
        self.params = params
        n = params.n
        if special_bits is None:
            # follow the chain policy (fhe/params.py): 30-bit specials at
            # n=65536.  The only stated reason was an accelerator kernel
            # that no longer exists; the value is kept so chains and keys
            # do not change until a GPU measurement re-derives the policy
            # (ROADMAP.md design debt 2)
            special_bits = 30 if n >= 65536 else 31
        self.dnum = dnum                      # None -> per-limb digits
        n_sp = 1 if dnum is None else -(-params.L // dnum)
        # special primes: NTT primes not colliding with the chain
        sps = [p for p in make_prime_chain(n, [special_bits] * (n_sp + 2))
               if p not in params.moduli][:n_sp]
        assert len(sps) == n_sp
        self.special = sps[0]
        self.specials = tuple(sps)
        self.ctx = RnsContext.make(n, tuple(params.moduli) + tuple(sps))
        self.L = params.L                     # ciphertext primes
        self.keygen = KeyGen(self.ctx, self.L, params.sigma)
        self.rng = np.random.default_rng(seed)
        self.sk = self.keygen.gen_secret(self.rng)
        self.pk = self.keygen.gen_public(self.sk, self.rng)
        self._rlk: Optional[KeySwitchKey] = None
        self._galois: Dict[int, KeySwitchKey] = {}
        self._jits: Dict = {}

    @property
    def rlk(self) -> KeySwitchKey:
        if self._rlk is None:
            q = self.ctx.plan.q_arr[:, None]
            qinv = self.ctx.plan.qinv_arr[:, None]
            s2 = u32.mont_mul(self.sk.s_ntt, self.sk.s_ntt, q, qinv)
            self._rlk = self.keygen.gen_keyswitch(self.sk, s2, self.rng,
                                                  dnum=self.dnum)
        return self._rlk

    # -- keys ---------------------------------------------------------------
    def galois_key(self, g: int) -> KeySwitchKey:
        if g not in self._galois:
            perm = jnp.asarray(self.ctx.galois_perm(g))
            self._galois[g] = self.keygen.gen_keyswitch(
                self.sk, self.sk.s_ntt[:, perm], self.rng, dnum=self.dnum)
        return self._galois[g]

    def rotation_galois_element(self, r: int) -> int:
        n = self.params.n
        return pow(5, r % (n // 2), 2 * n)

    # -- encode / encrypt ---------------------------------------------------
    def encode(self, z, scale: Optional[float] = None,
               level: Optional[int] = None) -> Tuple[RnsPoly, float]:
        scale = scale or self.params.scale
        level = self.L - 1 if level is None else level
        data = encode(np.asarray(z), self.params.n, scale,
                      self.params.moduli[:level + 1])
        return RnsPoly(jnp.asarray(data), False), scale

    def encrypt(self, pt: RnsPoly, scale: float) -> Ciphertext:
        lvl = pt.level
        n = self.params.n
        from .keys import _rns_from_signed, _sample_gaussian, _sample_ternary
        u = _rns_from_signed(_sample_ternary(self.rng, n),
                             self.params.moduli[:lvl + 1])
        e0 = _rns_from_signed(_sample_gaussian(self.rng, n, self.params.sigma),
                              self.params.moduli[:lvl + 1])
        e1 = _rns_from_signed(_sample_gaussian(self.rng, n, self.params.sigma),
                              self.params.moduli[:lvl + 1])
        plan = self.ctx.plan.slice(lvl + 1)

        def enc(pt_data, u, e0, e1, pkb, pka):
            from ..ops.ntt_pease import negacyclic_ntt
            q = plan.q_arr[:, None]
            qinv = plan.qinv_arr[:, None]
            u_ntt = negacyclic_ntt(u, plan)
            m0_ntt = negacyclic_ntt(u32.add_mod(e0, pt_data, q), plan)
            m1_ntt = negacyclic_ntt(e1, plan)
            c0 = u32.add_mod(u32.mont_mul(pkb, u_ntt, q, qinv), m0_ntt, q)
            c1 = u32.add_mod(u32.mont_mul(pka, u_ntt, q, qinv), m1_ntt, q)
            return c0, c1

        c0, c1 = self._jit(("encrypt", lvl), enc)(
            pt.data, jnp.asarray(u), jnp.asarray(e0), jnp.asarray(e1),
            self.pk.b[:lvl + 1], self.pk.a[:lvl + 1])
        return Ciphertext([RnsPoly(c0, True), RnsPoly(c1, True)], scale)

    def encrypt_seeded(self, pt: RnsPoly, scale: float,
                       seed: int) -> Ciphertext:
        """Symmetric-key encryption whose c1 is expanded from `seed` by the
        frozen SHAKE-256 stream (fhe/serialize.py:sample_uniform_a), so the
        ciphertext qualifies for the half-size seeded wire form — SEAL's
        Serializable<Ciphertext> semantics (the reference's perf suite times
        these save paths, profile_framewk/src/framewk.cpp serialize rows).

        c1 = a (uniform, NTT/Montgomery domain), c0 = m + e - a·s, so the
        standard decrypt c0 + c1·s recovers m + e."""
        from .serialize import sample_uniform_a
        lvl = pt.level
        n = self.params.n
        from .keys import _rns_from_signed, _sample_gaussian
        moduli = self.params.moduli[:lvl + 1]
        a = jnp.asarray(sample_uniform_a(seed, (lvl + 1, n), moduli))
        e = _rns_from_signed(_sample_gaussian(self.rng, n, self.params.sigma),
                             moduli)
        plan = self.ctx.plan.slice(lvl + 1)

        def enc(pt_data, a, e, s_ntt):
            from ..ops.ntt_pease import negacyclic_ntt
            q = plan.q_arr[:, None]
            qinv = plan.qinv_arr[:, None]
            m_ntt = negacyclic_ntt(u32.add_mod(e, pt_data, q), plan)
            c0 = u32.sub_mod(m_ntt, u32.mont_mul(a, s_ntt, q, qinv), q)
            return c0

        c0 = self._jit(("encrypt_seeded", lvl), enc)(
            pt.data, a, jnp.asarray(e), self.sk.s_ntt[:lvl + 1])
        return Ciphertext([RnsPoly(c0, True), RnsPoly(a, True)], scale)

    def decrypt(self, ct: Ciphertext) -> RnsPoly:
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
            from ..ops.ntt_pease import negacyclic_intt
            return negacyclic_intt(acc, plan)

        out = self._jit(("decrypt", ct.size, lvl), dec)(
            [c.data for c in ct.c], self.sk.s_ntt[:lvl + 1])
        return RnsPoly(out, False)

    def decrypt_decode(self, ct: Ciphertext, exact: bool = False
                       ) -> np.ndarray:
        """Decrypt + decode.  Default path reconstructs the (small, centered)
        plaintext coefficients on-device via fixed-point CRT (ops/crt64.py,
        exact for |coeff| < 2^62 — i.e. scale·|m|+noise < 2^62); exact=True
        falls back to the host object-int CRT for oversized coefficients."""
        if exact:
            pt = self.decrypt(ct)
            signed = rns_to_signed(np.asarray(pt.data),
                                   self.params.moduli[:ct.level + 1])
            return decode(signed.astype(np.float64), self.params.n, ct.scale)
        lvl = ct.level
        plan = self.ctx.plan.slice(lvl + 1)
        cplan = self._crt64_plan(lvl)

        def dec64(cs, s):
            from ..ops.crt64 import crt_to_words
            q = plan.q_arr[:, None]
            qinv = plan.qinv_arr[:, None]
            acc = cs[0]
            spow = s
            for comp in cs[1:]:
                acc = u32.add_mod(acc, u32.mont_mul(comp, spow, q, qinv), q)
                spow = u32.mont_mul(spow, s, q, qinv)
            from ..ops.ntt_pease import negacyclic_intt
            return crt_to_words(negacyclic_intt(acc, plan), cplan)

        hi, lo = self._jit(("decrypt64", ct.size, lvl), dec64)(
            [c.data for c in ct.c], self.sk.s_ntt[:lvl + 1])
        from ..ops.crt64 import words_to_signed
        signed = words_to_signed(np.asarray(hi), np.asarray(lo))
        return decode(signed.astype(np.float64), self.params.n, ct.scale)

    def _crt64_plan(self, lvl: int):
        if not hasattr(self, "_crt64_plans"):
            self._crt64_plans = {}
        if lvl not in self._crt64_plans:
            from ..ops.crt64 import Crt64Plan
            self._crt64_plans[lvl] = Crt64Plan.make(
                self.params.moduli[:lvl + 1])
        return self._crt64_plans[lvl]

    # -- evaluator (raw impls; public wrappers below are jit-cached) --------
    def _add_impl(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return Ciphertext(
            [poly_add(x, y, self.ctx) for x, y in zip(a.c, b.c)], a.scale)

    def _sub_impl(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return Ciphertext(
            [poly_sub(x, y, self.ctx) for x, y in zip(a.c, b.c)], a.scale)

    def _multiply_impl(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        mul = lambda x, y: poly_mul_pointwise(x, y, self.ctx)
        d0 = mul(a.c[0], b.c[0])
        d1 = poly_add(mul(a.c[0], b.c[1]), mul(a.c[1], b.c[0]), self.ctx)
        d2 = mul(a.c[1], b.c[1])
        return Ciphertext([d0, d1, d2], a.scale * b.scale)

    def _relinearize_impl(self, ct: Ciphertext, rlk) -> Ciphertext:
        d2_coeff = poly_intt(ct.c[2], self.ctx)
        k0, k1 = keyswitch(d2_coeff.data, rlk, ct.level, self.ctx, self.L,
                           t=self._ks_t, dnum=self.dnum)
        c0 = poly_add(ct.c[0], RnsPoly(k0, True), self.ctx)
        c1 = poly_add(ct.c[1], RnsPoly(k1, True), self.ctx)
        return Ciphertext([c0, c1], ct.scale)

    def _rescale_impl(self, ct: Ciphertext) -> Ciphertext:
        """Drop alpha top limbs (alpha=2 for the composite-scale regime:
        the pair of primes whose product is one scale factor)."""
        cs, scale = ct.c, ct.scale
        for _ in range(self.params.alpha):
            q_top = self.params.moduli[cs[0].level]
            cs = [rescale(p, self.ctx) for p in cs]
            scale /= q_top
        return Ciphertext(cs, scale)

    def _multiply_plain_impl(self, ct: Ciphertext, pt: RnsPoly,
                             pt_scale: float) -> Ciphertext:
        pt_ntt = poly_ntt(pt, self.ctx) if not pt.is_ntt else pt
        return Ciphertext(
            [poly_mul_pointwise(c, pt_ntt, self.ctx) for c in ct.c],
            ct.scale * pt_scale)

    def _apply_galois_impl(self, ct: Ciphertext, ksk, g: int) -> Ciphertext:
        c0g = poly_automorphism(ct.c[0], g, self.ctx)
        c1g = poly_automorphism(ct.c[1], g, self.ctx)
        c1_coeff = poly_intt(c1g, self.ctx)
        k0, k1 = keyswitch(c1_coeff.data, ksk, ct.level, self.ctx, self.L,
                           t=self._ks_t, dnum=self.dnum)
        c0 = poly_add(c0g, RnsPoly(k0, True), self.ctx)
        return Ciphertext([c0, RnsPoly(k1, True)], ct.scale)

    # -- public evaluator (cached jit per (op, shapes, static metadata)) ----
    _ks_t = None      # BGV subclassing hook: plaintext modulus for keyswitch

    def _jit(self, name, fn):
        if name not in self._jits:
            from ..utils.jitcache import hoisted_jit
            self._jits[name] = hoisted_jit(fn)
        return self._jits[name]

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert abs(a.scale - b.scale) / a.scale < 1e-9 and a.level == b.level
        return self._jit("add", self._add_impl)(a, b)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.level == b.level
        return self._jit("sub", self._sub_impl)(a, b)

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """Tensor product: (a0,a1)x(b0,b1) -> (d0, d1, d2), scales multiply."""
        assert a.size == 2 and b.size == 2 and a.level == b.level
        return self._jit("multiply", self._multiply_impl)(a, b)

    def relinearize(self, ct: Ciphertext) -> Ciphertext:
        assert ct.size == 3
        return self._jit("relinearize", self._relinearize_impl)(ct, self.rlk)

    def multiply_relin(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.size == 2 and b.size == 2 and a.level == b.level
        return self._jit(
            "multiply_relin",
            lambda x, y, k: self._relinearize_impl(self._multiply_impl(x, y), k)
        )(a, b, self.rlk)

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        return self._jit("rescale", self._rescale_impl)(ct)

    def multiply_plain(self, ct: Ciphertext, pt: RnsPoly,
                       pt_scale: float) -> Ciphertext:
        out = self._jit("multiply_plain",
                        lambda c, p: self._multiply_plain_impl(c, p, 1.0))(ct, pt)
        return Ciphertext(out.c, ct.scale * pt_scale, out.correction)

    def apply_galois(self, ct: Ciphertext, g: int) -> Ciphertext:
        """σ_g then keyswitch σ_g(s) -> s."""
        assert ct.size == 2
        ksk = self.galois_key(g)
        return self._jit(("galois", g),
                         lambda c, k: self._apply_galois_impl(c, k, g))(ct, ksk)

    def rotate(self, ct: Ciphertext, r: int) -> Ciphertext:
        """Rotate slots by r positions."""
        return self.apply_galois(ct, self.rotation_galois_element(r))

    def conjugate(self, ct: Ciphertext) -> Ciphertext:
        return self.apply_galois(ct, 2 * self.params.n - 1)
