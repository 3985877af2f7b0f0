"""Protected CKKS/BGV evaluator: ABFT detectors on the production kernels,
engineered to FUSE (round-4 verdict item #1).

The reference's end-to-end overhead story is a cost model
(profile_framewk/draw_scripts/draw_atom_opt_cost.py:11-15: NTT x1.009-1.033,
BaseConv ~x1.000, ModMul x1.1406, Others x2) — its detectors were never
integrated into SEAL's evaluator.  Round 2-4 of this framework integrated
them by recompute-and-compare (duplicated permute/tree-sum behind
optimization_barriers, per-stage NttGuard projections, per-element fold
checks on every dyadic MAC) and measured the honest price: x4.7-5.9 device
time.  This version replaces recomputation with CHECKED ALGEBRA — every
linear span of the keyswitch is verified by one modular dot against a
probe precomputed through the span's transpose — so the checks are O(n)
reductions XLA fuses into the surrounding kernels:

  PERMUTE    <φ, c0∘σ> == <φ∘σ⁻¹, c0>: the projection commutes with the
             automorphism, so the permuted probe is a build-time gather
             (replaces the barriered duplicate gather; same ~1/q bound as
             every projection here)
  INTT       composed check <φ, d> == <(M⁻ᵀφ)∘σ⁻¹, c1>: covers the c1
             permute AND the inverse transform in two dots
             (protect/ntt_guard.py's vi tables, permuted at build)
  BASECONV   appended-checksum ECC in the exact-integer form
             (baseConv.py:42-98 rebuilt on exact u64 input sums; shared
             with the plain path via fhe/keys.py:compute_digits)
  KS CORE    ONE projection through the whole linear span
             digits → NTT → ⊙ksk → Σ_digits: for fixed keys
             acc_c = Σ_j M(dig_j)∘k_cj∘R⁻¹ with k_c = k_b + ρ∘k_a (random
             per-limb ρ folds both accumulators into one check), so
             <φ, acc_0 + ρ∘acc_1> == Σ_j <Mᵀ(φ∘k_cj∘R⁻¹), dig_j> with the
             transposed probe V_j = NttGuard.transpose_probe(φ⊙k_cj) built
             once per (key, level).  Replaces the per-stage NTT projection,
             the per-element MULTEVK fold check, and the barriered duplicate
             tree-sum — and CLOSES their inter-stage storage-miss windows
             (prod0/acc0 now sit inside the checked span).
  MODDOWN    NttGuard on the special-limb INTT + the exact centered-lift
             checksum (sum(delta_i) == S - q_sp*n_over mod q_i, t-aware in
             BGV) + a composite projection
             <φ, out> == q_src⁻¹·(<φ, acc> − <Mᵀφ, δ>) covering the delta
             NTT, the subtraction and the rescale in three dots
  RANGE      out ∈ [0, q) windows on the mod-down outputs
             (barrett_inner.py:53-95's detector class)

Scope: every keyswitch configuration the plain evaluators run — per-limb
or dnum-grouped digits, one or multiple special primes, CKKS (t=None) and
BGV (t-aware mod-down).  The digit path is SHARED with the plain evaluator
(fhe/keys.py:compute_digits with_ecc=True), so the protected and plain
keyswitches cannot silently diverge.

Returned flags are per-phase booleans; `all_ok(flags)` reduces them.  The
flip campaign (faults/evaluator_campaign.py) injects single-bit faults into
each intermediate and verifies the matching detector fires; only ks_out
(a flip into the final output, after the last read) remains a designed
miss window.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..numth import shoup_precompute
from ..ops import u32
from ..ops.modring import sum_mod
from ..protect.checks import mont_mul_checked, sum_u64_exact
from ..protect.ntt_guard import NttGuard
from .ckks import Ciphertext, CkksContext
from .keys import _basis_plan, _sum_digits, compute_digits
from .rns import RnsPoly, _mont_qinv, _mont_r2, lift_to_limbs, limb_plan


@dataclass(frozen=True)
class Fault:
    """Single-bit flip injected into a named keyswitch intermediate.

    stage is static (one compile per stage); limb/idx/bit may be Python ints
    or traced scalars (campaigns sweep them without recompiling)."""
    stage: str            # c1_perm | intt_out | digits | digits_ntt |
                          # prod0 | acc0 | ks_out
    limb: object = 0
    idx: object = 0
    bit: object = 0


def _flip2(x: jnp.ndarray, limb, idx, bit) -> jnp.ndarray:
    """XOR bit into element [limb, idx] of a (L, N) array.

    Formulated as a one-hot XOR mask, NOT a scatter: vmapped scatters with
    traced indices into a trial-invariant operand were observed to
    silently DROP updates at batch >= ~1024 on the first accelerator
    runtime this ran on (the faulted output equaled the clean one
    bit-for-bit — the flip vanished, it did not cancel).  Whether a GPU
    scatter is exact here is untested; evaluator_campaign.check_row
    guards the campaign either way.  The mask form lowers to pure
    elementwise ops and is immune; cost is one L*N compare per flip."""
    onehot = (jnp.arange(x.shape[0])[:, None] == limb) \
        & (jnp.arange(x.shape[1])[None, :] == idx)
    mask = jnp.where(onehot, jnp.uint32(1) << jnp.asarray(bit, jnp.uint32),
                     jnp.uint32(0))
    return x ^ mask


def _check_set(checks, universe):
    if checks is None:
        return universe
    cs = frozenset(checks)
    bad = cs - universe
    if bad:
        raise ValueError(f"unknown detector families {sorted(bad)}; "
                         f"valid: {sorted(universe)}")
    return cs


def all_ok(flags: Dict[str, jnp.ndarray]) -> jnp.ndarray:
    acc = None
    for v in flags.values():
        r = jnp.all(v)
        acc = r if acc is None else acc & r
    return acc


@dataclass(frozen=True)
class KsProbe:
    """Precomputed keyswitch-core projection for one (key, level): the
    transposed probe V_j = Mᵀ(φ∘k_cj∘R⁻¹) per digit and active limb, and
    the per-limb accumulator-combining scalars ρ (with Shoup companions)."""
    V: jnp.ndarray            # (n_used, n_lim, n) Montgomery
    rho: jnp.ndarray          # (n_lim,)
    rho_shoup: jnp.ndarray    # (n_lim,)


class ProtectedCkks:
    """Detector-instrumented evaluator over an existing CkksContext.

    rotate(ct, r) / multiply_relin(a, b) mirror the plain evaluator's
    results bit-for-bit (tests/test_protected.py) and additionally return
    the per-phase ok flags."""

    #: detector families; subset via `checks=` for ablation/overhead tuning
    ALL_CHECKS = frozenset({"permute", "intt", "baseconv", "ks_core",
                            "md_intt", "md_lift", "md_proj", "md_range",
                            "dyadic"})

    def __init__(self, ckks: CkksContext, checks=None):
        self.ckks = ckks
        self.guard = NttGuard.make(ckks.ctx.plan)
        self._ks_t = getattr(ckks, "_ks_t", None)    # None for CKKS
        self._jits: Dict = {}
        self._probes: Dict = {}
        self.checks = _check_set(checks, self.ALL_CHECKS)

    def _on(self, name: str) -> bool:
        return name in self.checks

    def _jit(self, name, fn):
        if name not in self._jits:
            from ..utils.jitcache import hoisted_jit
            self._jits[name] = hoisted_jit(fn)
        return self._jits[name]

    # ------------------------------------------------------------------
    # probe construction (once per key/level; cached)
    # ------------------------------------------------------------------
    def _active_basis(self, level: int):
        ckks, ctx = self.ckks, self.ckks.ctx
        L = ckks.L
        n_sp = len(ctx.moduli) - L
        active = level + 1
        sp_idx = list(range(L, L + n_sp))
        lim = list(range(active)) + sp_idx
        from .keys import _digit_groups
        dnum = ckks.dnum if ckks.dnum is not None else L
        groups = _digit_groups(L, dnum)
        used = [gi for gi, grp in enumerate(groups)
                if any(l < active for l in grp)]
        return used, lim, sp_idx

    def _ks_probe(self, ksk, level: int, salt: int) -> KsProbe:
        """Build (or fetch) the keyswitch-core probe for this key/level.
        ρ is drawn from a fixed seed derived from (salt, level) so
        campaigns are reproducible across runs."""
        key = (id(ksk.b), level)
        hit = self._probes.get(key)
        if hit is not None:
            return hit
        ctx = self.ckks.ctx
        used, lim, _ = self._active_basis(level)
        sub_plan = _basis_plan(ctx, lim)
        g_sub = self.guard.take(lim)
        qb = sub_plan.q_arr[:, None]
        qinvb = sub_plan.qinv_arr[:, None]
        used_idx = jnp.asarray(used)
        lim_idx = jnp.asarray(lim)
        kb = ksk.b[used_idx][:, lim_idx]
        ka = ksk.a[used_idx][:, lim_idx]
        qs = [int(ctx.moduli[i]) for i in lim]
        rng = np.random.default_rng((0xA5F0_0D00 + salt) * 2654435761
                                    % (1 << 63) + level)
        rho = np.array([rng.integers(1, q) for q in qs], dtype=np.uint32)
        rho_s = np.array([shoup_precompute(int(r), q)
                          for r, q in zip(rho, qs)], dtype=np.uint32)
        kc = u32.add_mod(
            kb, u32.mul_mod_shoup(ka, rho[:, None], rho_s[:, None], qb), qb)
        w = u32.mont_mul(g_sub.phi_mont, kc, qb, qinvb)   # φ∘k_c (stored)
        V = g_sub.transpose_probe(sub_plan, w)
        probe = KsProbe(V=V, rho=jnp.asarray(rho), rho_shoup=jnp.asarray(rho_s))
        self._probes[key] = probe
        return probe

    def _perm_probe(self, g: int, active: int):
        """Permuted projection tables for automorphism g at `active` limbs:
        φ∘σ⁻¹ and (M⁻ᵀφ)∘σ⁻¹, gathered at build time (host)."""
        key = ("perm", g, active)
        hit = self._probes.get(key)
        if hit is not None:
            return hit
        perm = np.asarray(self.ckks.ctx.galois_perm(g))
        perm_inv = np.empty_like(perm)
        perm_inv[perm] = np.arange(perm.shape[0])
        phi_pi = jnp.asarray(
            np.asarray(self.guard.phi_mont)[:active][:, perm_inv])
        vi_pi = jnp.asarray(
            np.asarray(self.guard.vi_mont)[:active][:, perm_inv])
        entry = (jnp.asarray(perm), phi_pi, vi_pi)
        self._probes[key] = entry
        return entry

    # ------------------------------------------------------------------
    # protected keyswitch core
    # ------------------------------------------------------------------
    def _keyswitch_protected(self, d: jnp.ndarray, level: int,
                             ksk_b: jnp.ndarray, ksk_a: jnp.ndarray,
                             probe: KsProbe,
                             flags: Dict, fault: Optional[Fault]):
        """Full protected hybrid keyswitch: digits (shared implementation,
        fhe/keys.py:compute_digits with the appended-checksum ECC), then the
        single KS-CORE projection over digits → NTT → ⊙ksk → Σ (see module
        docstring), then the guarded multi-special mod-down.  Supports every
        (dnum, n_special, t) configuration the plain fhe/keys.py:keyswitch
        does — same algebra, same tables."""
        ctx = self.ckks.ctx
        L = self.ckks.L
        dnum = self.ckks.dnum
        n_sp = len(ctx.moduli) - L
        sp_idx = list(range(L, L + n_sp))
        active = level + 1
        # BASECONV: the production digit path + exact-sum checksum refs
        on_ecc = self._on("baseconv")
        if on_ecc:
            dig, used, lim, refs = compute_digits(d, level, ctx, L, dnum,
                                                  with_ecc=True)
        else:
            dig, used, lim = compute_digits(d, level, ctx, L, dnum)
        if fault is not None and fault.stage == "digits":
            dig = dig.at[0].set(_flip2(dig[0], fault.limb, fault.idx,
                                       fault.bit))
        sub_plan = _basis_plan(ctx, lim)
        q1 = sub_plan.q_arr                      # (n_lim,)
        if on_ecc:
            flags["baseconv"] = sum_mod(dig, q1, axis=-1) == refs

        g_sub = self.guard.take(lim)
        q_lim = sub_plan.q_arr[:, None]
        qinv_lim = sub_plan.qinv_arr[:, None]

        from ..ops.ntt_pease import negacyclic_ntt
        dig_ntt = negacyclic_ntt(dig, sub_plan)
        if fault is not None and fault.stage == "digits_ntt":
            dig_ntt = dig_ntt.at[0].set(_flip2(dig_ntt[0], fault.limb,
                                               fault.idx, fault.bit))
        # MULTEVK: plain dyadic MACs — the KS-CORE projection below covers
        # the multiplier (any corruption of t0/t1 shifts acc off the probe)
        lim_idx = jnp.asarray(lim)
        used_idx = jnp.asarray(used)
        kb = ksk_b[used_idx][:, lim_idx]
        ka = ksk_a[used_idx][:, lim_idx]
        t0 = u32.mont_mul(dig_ntt, kb, q_lim, qinv_lim)
        t1 = u32.mont_mul(dig_ntt, ka, q_lim, qinv_lim)
        if fault is not None and fault.stage == "prod0":
            t0 = t0.at[0].set(_flip2(t0[0], fault.limb, fault.idx, fault.bit))
        acc0 = _sum_digits(t0, q_lim)
        acc1 = _sum_digits(t1, q_lim)
        if fault is not None and fault.stage == "acc0":
            acc0 = _flip2(acc0, fault.limb, fault.idx, fault.bit)

        # KS CORE: one projection over the whole linear span (module
        # docstring).  lhs reads the (possibly faulted) accumulators; rhs
        # reads the digits through the transposed probe — faults anywhere
        # between unbalance the equation with miss probability ~1/q.
        if self._on("ks_core"):
            la = g_sub._dot(g_sub.phi_mont, acc0)
            lb = g_sub._dot(g_sub.phi_mont, acc1)
            lhs = u32.add_mod(
                la, u32.mul_mod_shoup(lb, probe.rho, probe.rho_shoup, q1), q1)
            rhs = sum_mod(g_sub._dot(probe.V, dig), q1, axis=0)
            flags["ks_core"] = lhs == rhs

        # MODDOWN by each special prime (t-aware in BGV), guarded — both
        # accumulators ride one batched call (mirrors fhe/keys.py:keyswitch:
        # the special-limb INTT and delta NTT amortize over the batch)
        acc = jnp.stack([acc0, acc1])
        for k_i in range(n_sp - 1, -1, -1):
            keep = list(range(active)) + sp_idx[:k_i]
            acc = self._drop_limb_protected(acc, sp_idx[k_i], keep, flags,
                                            f"md{k_i}" if k_i else "md",
                                            t=self._ks_t)
        if fault is not None and fault.stage == "ks_out":
            acc = acc.at[0].set(_flip2(acc[0], fault.limb, fault.idx,
                                       fault.bit))
        return acc[0], acc[1]

    def _drop_limb_protected(self, data: jnp.ndarray, src_k: int, keep,
                             flags: Dict, tag: str,
                             t: Optional[int] = None) -> jnp.ndarray:
        """rns.drop_limb with guarded transforms, the centered-lift checksum
        and the composite rescale projection.  data may carry leading batch
        dims (..., nk+1, N) — the keyswitch stacks both accumulators.
        t given = BGV mode: the lift is δ = [c]_c − q_src·[[c]_c·q_src^{-1}]_t,
        and the checksum tracks both exact sums (rns.drop_limb:215-258 is
        the unprotected twin)."""
        ctx = self.ckks.ctx
        nk = len(keep)
        lp = limb_plan(ctx, src_k)
        g_src = self.guard.take([src_k])
        from ..ops.ntt_pease import negacyclic_intt, negacyclic_ntt
        src_row = negacyclic_intt(data[..., nk:nk + 1, :], lp)
        if self._on("md_intt"):
            flags[f"{tag}_intt"] = g_src.check_inv(data[..., nk:nk + 1, :],
                                                   src_row)
        ck = src_row[..., 0, :]
        q_src = ctx.moduli[src_k]
        delta = lift_to_limbs(ck, src_k, keep, ctx, centered=True)
        on_lift = self._on("md_lift")
        # checksum ref: sum(delta_i) == (S - q_src*n_over) mod q_i, S exact
        if on_lift:
            s_hi, s_lo = sum_u64_exact(ck)
            n_over = jnp.sum((ck > (q_src // 2)).astype(jnp.uint32), axis=-1)
        if t is not None:
            # BGV correction r = [ck_c * q_src^{-1}]_t (centered), applied
            # per kept limb as delta -= q_src*r_c; checksum follows suit
            from ..numth import barrett_constants, mod_inv
            over = ck > (q_src // 2)
            mu_t, k_t = barrett_constants(t)
            inv_t = mod_inv(q_src, t)
            hi, lo = u32.mul32_parts(ck, jnp.uint32(inv_t))
            r = u32.barrett_reduce64(hi, lo, t, mu_t, k_t)
            r = jnp.where(over, u32.sub_mod(r, jnp.uint32(1), t), r)
            r_over = r > (t // 2)
            if on_lift:
                sr_hi, sr_lo = sum_u64_exact(r)
                n_r_over = jnp.sum(r_over.astype(jnp.uint32), axis=-1)
        oks = []
        rows = []
        for ri, i in enumerate(keep):
            qi = ctx.moduli[i]
            d_i = delta[..., ri, :]
            if on_lift:
                ref = u32.barrett_reduce64(s_hi, s_lo, qi, ctx.barrett_mu[i],
                                           ctx.barrett_k[i])
                corr = u32.mul_mod(jnp.uint32(q_src % qi),
                                   u32.barrett_reduce64(
                                       jnp.zeros_like(n_over), n_over, qi,
                                       ctx.barrett_mu[i], ctx.barrett_k[i]),
                                   qi, _mont_qinv(qi), _mont_r2(qi))
                ref = u32.sub_mod(ref, corr, jnp.uint32(qi))
            if t is not None:
                r_c = jnp.where(r_over, u32.sub_mod(
                    r, jnp.uint32(t % qi), qi), r)
                qs_r = u32.mul_mod(jnp.uint32(q_src % qi), r_c, qi,
                                   _mont_qinv(qi), _mont_r2(qi))
                d_i = u32.sub_mod(d_i, qs_r, qi)
                if on_lift:
                    # ref -= q_src * (S_r - t*n_r_over) mod q_i
                    sr_red = u32.barrett_reduce64(sr_hi, sr_lo, qi,
                                                  ctx.barrett_mu[i],
                                                  ctx.barrett_k[i])
                    tn = u32.mul_mod(jnp.uint32(t % qi),
                                     u32.barrett_reduce64(
                                         jnp.zeros_like(n_r_over), n_r_over,
                                         qi, ctx.barrett_mu[i],
                                         ctx.barrett_k[i]),
                                     qi, _mont_qinv(qi), _mont_r2(qi))
                    s_rc = u32.sub_mod(sr_red, tn, jnp.uint32(qi))
                    ref = u32.sub_mod(ref, u32.mul_mod(
                        jnp.uint32(q_src % qi), s_rc, qi, _mont_qinv(qi),
                        _mont_r2(qi)), jnp.uint32(qi))
            if on_lift:
                oks.append(ref)
            rows.append(d_i)
        delta = jnp.stack(rows, axis=-2)
        if on_lift:
            # one vectorized modular sum over all kept limbs (the per-limb
            # halving trees dominated the lift-checksum cost — round-5
            # ablation)
            q_keep = ctx.plan.q_arr[np.asarray(keep)]
            flags[f"{tag}_lift"] = \
                sum_mod(delta, q_keep, axis=-1) == jnp.stack(oks, axis=-1)
        keep_plan = ctx.plan.take(keep)
        delta_ntt = negacyclic_ntt(delta, keep_plan)
        keep_idx = np.asarray(keep)
        q_lo = ctx.plan.q_arr[keep_idx, None]
        num = u32.sub_mod(data[..., :nk, :], delta_ntt, q_lo)
        out = u32.mul_mod_shoup(num, ctx.qk_inv[src_k][keep_idx, None],
                                ctx.qk_inv_shoup[src_k][keep_idx, None], q_lo)
        # composite rescale projection: out = (acc − M δ)·q_src⁻¹, so
        # <φ, out> == q_src⁻¹·(<φ, acc> − <Mᵀφ, δ>) — three fused dots
        # covering the delta NTT, the subtraction and the Shoup rescale
        if self._on("md_proj"):
            g_keep = self.guard.take(keep)
            qv = ctx.plan.q_arr[keep_idx]
            pa = g_keep._dot(g_keep.phi_mont, data[..., :nk, :])
            pd = g_keep._dot(g_keep.vf_mont, delta)
            po = g_keep._dot(g_keep.phi_mont, out)
            rhs = u32.mul_mod_shoup(u32.sub_mod(pa, pd, qv),
                                    ctx.qk_inv[src_k][keep_idx],
                                    ctx.qk_inv_shoup[src_k][keep_idx], qv)
            flags[f"{tag}_proj"] = po == rhs
        if self._on("md_range"):
            flags[f"{tag}_range"] = jnp.all(out < q_lo)
        return out

    # ------------------------------------------------------------------
    # public protected ops
    # ------------------------------------------------------------------
    def _galois_impl(self, ct: Ciphertext, ksk, g: int, level: int,
                     fault: Optional[Fault],
                     probe: Optional[KsProbe] = None, perm_probe=None):
        """probe/perm_probe must be prebuilt OUTSIDE any trace (apply_galois
        does; callers invoking this directly — bench/protected_overhead —
        pass them explicitly or rely on the cache being warm: building them
        from a traced ksk would bake tracers into the probe cache."""
        ckks, ctx = self.ckks, self.ckks.ctx
        flags: Dict[str, jnp.ndarray] = {}
        active = level + 1
        perm, phi_pi, vi_pi = perm_probe or self._perm_probe(g, active)
        if probe is None:
            probe = self._probes[(id(ksk.b), level)]   # must be warm
        plan = ctx.plan.slice(active)
        g_act = self.guard.slice(active)
        c0, c1 = ct.c[0].data, ct.c[1].data
        c0g = c0[:, perm]
        c1g = c1[:, perm]
        # permute projection: <φ, c0∘σ> == <φ∘σ⁻¹, c0> (build-time gather)
        if self._on("permute"):
            flags["permute"] = \
                g_act._dot(g_act.phi_mont, c0g) == g_act._dot(phi_pi, c0)
        if fault is not None and fault.stage == "c1_perm":
            c1g = _flip2(c1g, fault.limb, fault.idx, fault.bit)
        from ..ops.ntt_pease import negacyclic_intt
        d = negacyclic_intt(c1g, plan)
        if fault is not None and fault.stage == "intt_out":
            d = _flip2(d, fault.limb, fault.idx, fault.bit)
        # composed permute+INTT check: <φ, d> == <(M⁻ᵀφ)∘σ⁻¹, c1>
        if self._on("intt"):
            flags["intt"] = \
                g_act._dot(g_act.phi_mont, d) == g_act._dot(vi_pi, c1)
        k0, k1 = self._keyswitch_protected(d, level, ksk.b, ksk.a, probe,
                                           flags, fault)
        qb = plan.q_arr[:, None]
        c0_out = u32.add_mod(c0g, k0, qb)
        return (Ciphertext([RnsPoly(c0_out, True), RnsPoly(k1, True)],
                           ct.scale, correction=ct.correction), flags)

    def apply_galois(self, ct: Ciphertext, g: int,
                     fault: Optional[Fault] = None
                     ) -> Tuple[Ciphertext, Dict]:
        assert ct.size == 2
        ksk = self.ckks.galois_key(g)
        lvl = ct.level
        probe = self._ks_probe(ksk, lvl, salt=g)     # build outside the trace
        pp = self._perm_probe(g, lvl + 1)
        key = ("pgalois", g, lvl, fault.stage if fault else None)
        if fault is None:
            fn = self._jit(key, lambda c, k: self._galois_impl(
                c, k, g, lvl, None, probe, pp))
            return fn(ct, ksk)
        fn = self._jit(key, lambda c, k, li, ix, bi: self._galois_impl(
            c, k, g, lvl,
            Fault(fault.stage, li, ix, bi), probe, pp))
        return fn(ct, ksk, jnp.asarray(fault.limb), jnp.asarray(fault.idx),
                  jnp.asarray(fault.bit))

    def rotate(self, ct: Ciphertext, r: int,
               fault: Optional[Fault] = None) -> Tuple[Ciphertext, Dict]:
        return self.apply_galois(
            ct, self.ckks.rotation_galois_element(r), fault)

    def _mul_relin_impl(self, ac, bc, kb, ka, probe: KsProbe, level: int,
                        scale, correction, fault: Optional[Fault]):
        """Tensor product (checked dyadic products) + protected relin.
        ac/bc: [c0, c1] data arrays; kb/ka: full relin key arrays."""
        ckks, ctx = self.ckks, self.ckks.ctx
        plan = ctx.plan.slice(level + 1)
        qb = plan.q_arr[:, None]
        qinvb = plan.qinv_arr[:, None]
        flags: Dict[str, jnp.ndarray] = {}
        prods = []
        oks = []
        for (x, y) in ((ac[0], bc[0]), (ac[0], bc[1]), (ac[1], bc[0]),
                       (ac[1], bc[1])):
            if self._on("dyadic"):
                p, ok = mont_mul_checked(x, y, qb, qinvb)
                oks.append(jnp.all(ok))
            else:
                p = u32.mont_mul(x, y, qb, qinvb)
            prods.append(p)
        if oks:
            flags["dyadic"] = jnp.stack(oks)
        d0 = prods[0]
        d1 = u32.add_mod(prods[1], prods[2], qb)
        d2 = prods[3]
        from ..ops.ntt_pease import negacyclic_intt
        d2c = negacyclic_intt(d2, plan)
        if fault is not None and fault.stage == "intt_out":
            d2c = _flip2(d2c, fault.limb, fault.idx, fault.bit)
        if self._on("intt"):
            flags["intt"] = self.guard.slice(level + 1).check_inv(d2, d2c)
        k0, k1 = self._keyswitch_protected(d2c, level, kb, ka, probe,
                                           flags, fault)
        c0 = u32.add_mod(d0, k0, qb)
        c1 = u32.add_mod(d1, k1, qb)
        return (Ciphertext([RnsPoly(c0, True), RnsPoly(c1, True)],
                           scale, correction=correction), flags)

    def multiply_relin(self, a: Ciphertext, b: Ciphertext,
                       fault: Optional[Fault] = None
                       ) -> Tuple[Ciphertext, Dict]:
        assert a.size == 2 and b.size == 2 and a.level == b.level
        ckks = self.ckks
        lvl = a.level
        rlk = ckks.rlk
        probe = self._ks_probe(rlk, lvl, salt=-1)
        corr = ((a.correction * b.correction) % self._ks_t
                if self._ks_t else 1)
        sc = a.scale * b.scale
        key = ("pmulrelin", lvl, fault.stage if fault else None)
        if fault is None:
            fn = self._jit(key, lambda ac, bc, kb, ka: self._mul_relin_impl(
                ac, bc, kb, ka, probe, lvl, sc, corr, None))
            return fn([c.data for c in a.c], [c.data for c in b.c],
                      rlk.b, rlk.a)
        fn = self._jit(key, lambda ac, bc, kb, ka, li, ix, bi:
                       self._mul_relin_impl(
                           ac, bc, kb, ka, probe, lvl, sc, corr,
                           Fault(fault.stage, li, ix, bi)))
        return fn([c.data for c in a.c], [c.data for c in b.c],
                  rlk.b, rlk.a, jnp.asarray(fault.limb),
                  jnp.asarray(fault.idx), jnp.asarray(fault.bit))


class ProtectedBgv(ProtectedCkks):
    """Detector-instrumented BGV evaluator: the same protected keyswitch
    with the t-aware mod-down (δ ≡ 0 mod t; rns.drop_limb BGV branch) and
    decryption corrections tracked as in fhe/bgv.py.  rotate_rows and
    multiply_relin mirror BgvContext's results bit-for-bit
    (tests/test_protected.py)."""

    def __init__(self, bgv, checks=None):
        # BgvContext exposes the same surface the protected core needs:
        # .ctx, .L, .dnum, .galois_key, .rlk
        self.ckks = bgv
        self.guard = NttGuard.make(bgv.ctx.plan)
        self._ks_t = bgv.t
        self._jits: Dict = {}
        self._probes: Dict = {}
        self.checks = _check_set(checks, self.ALL_CHECKS)

    def rotate_rows(self, ct: Ciphertext, r: int,
                    fault: Optional[Fault] = None) -> Tuple[Ciphertext, Dict]:
        n = self.ckks.params.n
        return self.apply_galois(ct, pow(5, r % (n // 2), 2 * n), fault)
