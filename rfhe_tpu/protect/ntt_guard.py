"""End-to-end ABFT projection guard for the production NTT.

The reference's four-step protections check each stage of a simulator NTT
(rfhe_framewk/src/ntt_test/relia_ntt_sim.py:179-219); its *production*
overhead story (profile_framewk/draw_scripts/draw_atom_opt_cost.py:11-15)
was never integrated into SEAL's evaluator.  This module goes further: a
detector that rides the kernels the scheme layer actually runs
(ops/ntt_mxu.MxuNttPlan — XLA composition or the fused Pallas kernel,
which are bit-exact to each other), so fhe.protected can measure overhead
and run flip campaigns on the real path.

Mechanism.  The negacyclic NTT is linear per limb: y = M x over Z_q with
M[p, t] = R·ψ^t·ω^(nu[p]·t) (slot order nu, Montgomery factor R = 2^32
included — the check operates on the stored uint32 values, so no domain
conversions are needed at runtime).  Fix a random projection φ per limb and
precompute v = Mᵀφ once per plan; then every transform is verified by two
length-n modular dot products

    <φ, y>  ==  <v, x>   (mod q)

— O(n) work against the transform's O(n·(n1+n2)) — with miss probability
~1/q for any fault that corrupts the output (the standard ABFT collision
bound, same model as relia_ntt_sim.py's projection stages).  vᵀ = φᵀM is
computed by the plan itself (one device transform per direction at build):
for h[k] = φ[nu_inv[k]],

    (Mᵀφ)[t] = R·ψ^t·Ĥ[t],     Ĥ = fwd(h ⊙ ψ^{-t} ⊙ R^{-1})[nu_inv]

and the inverse direction uses Ĝ[k] = Ĝ⁺[(n-k) mod n] with the same trick
(the ω-NTT of g evaluated at -k).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..numth import PrimeCtx, mod_inv
from ..ops import u32
from ..ops.modring import sum_mod

__all__ = ["NttGuard"]


def _pow_table(base: int, count: int, q: int) -> np.ndarray:
    out = np.empty(count, dtype=np.uint64)
    v = 1
    for i in range(count):
        out[i] = v
        v = (v * base) % q
    return out


@dataclass(frozen=True)
class NttGuard:
    """Projection tables for one MxuNttPlan (all limbs, stacked)."""

    phi_mont: jnp.ndarray     # (L, n) uint32, φ·R mod q
    vf_mont: jnp.ndarray      # (L, n) uint32, (Mᵀφ)·R mod q   (forward)
    vi_mont: jnp.ndarray      # (L, n) uint32, (M⁻ᵀφ)·R mod q  (inverse)
    q_arr: jnp.ndarray        # (L,)
    qinv_arr: jnp.ndarray
    # transpose-probe tables (arbitrary-probe Mᵀu at build time; see
    # transpose_probe): ψ^{-t} plain and ψ^t·R² per limb
    psi_inv: jnp.ndarray = None    # (L, n) uint32
    dmont: jnp.ndarray = None      # (L, n) uint32

    @classmethod
    def make(cls, plan, seed: int = 2024) -> "NttGuard":
        n = plan.n
        qs = [int(q) for q in np.asarray(plan.q_arr)]
        L = len(qs)
        rng = np.random.default_rng(seed)
        nu = plan.nu
        nu_inv = plan.nu_inv
        phi = np.stack([
            rng.integers(1, q, n, dtype=np.uint64) for q in qs])
        zf = np.empty((L, n), dtype=np.uint32)
        zg = np.empty((L, n), dtype=np.uint32)
        psi_pows = []
        for li, q in enumerate(qs):
            ctx = PrimeCtx.make(q, n)
            psii = mod_inv(ctx.psi, q)
            pi = _pow_table(psii, n, q)
            psi_pows.append((_pow_table(ctx.psi, n, q), pi))
            rinv = mod_inv((1 << 32) % q, q)
            h = phi[li][nu_inv]
            zf[li] = (h * pi % q) * rinv % q
            # inverse probe g = φ ⊙ ψ^{-t}, fed through the ψ-untwist too
            zg[li] = (phi[li] * pi % q * pi % q) * rinv % q
        # one device transform per direction computes both projections
        Hf = np.asarray(plan.fwd(jnp.asarray(zf)), dtype=np.uint64)[:, nu_inv]
        Gp = np.asarray(plan.fwd(jnp.asarray(zg)), dtype=np.uint64)[:, nu_inv]
        vf = np.empty((L, n), dtype=np.uint32)
        vi = np.empty((L, n), dtype=np.uint32)
        phi_m = np.empty((L, n), dtype=np.uint32)
        psi_i = np.empty((L, n), dtype=np.uint32)
        dm = np.empty((L, n), dtype=np.uint32)
        t = np.arange(n)
        for li, q in enumerate(qs):
            R = (1 << 32) % q
            pw, pi = psi_pows[li]
            # vf = R·ψ^t·Ĥ[t]; store in Montgomery form (·R again)
            vf[li] = (Hf[li] * pw % q) * R % q * R % q
            # vi[p] = n^{-1}·R^{-1}·Ĝ[nu[p]], Ĝ[k] = Ĝ⁺[(n-k) mod n]
            G = Gp[li][(n - nu) % n]
            c = mod_inv(n, q) * mod_inv(R, q) % q
            vi[li] = (G * c % q) * R % q
            phi_m[li] = phi[li] * R % q
            psi_i[li] = pi.astype(np.uint32)
            dm[li] = (pw % q) * R % q * R % q
        return cls(
            phi_mont=jnp.asarray(phi_m), vf_mont=jnp.asarray(vf),
            vi_mont=jnp.asarray(vi),
            q_arr=plan.q_arr, qinv_arr=plan.qinv_arr,
            psi_inv=jnp.asarray(psi_i), dmont=jnp.asarray(dm))

    @property
    def L(self) -> int:
        return int(self.q_arr.shape[0])

    def take(self, idx) -> "NttGuard":
        idx = np.asarray(idx)
        return NttGuard(
            phi_mont=self.phi_mont[idx], vf_mont=self.vf_mont[idx],
            vi_mont=self.vi_mont[idx],
            q_arr=self.q_arr[idx], qinv_arr=self.qinv_arr[idx],
            psi_inv=None if self.psi_inv is None else self.psi_inv[idx],
            dmont=None if self.dmont is None else self.dmont[idx])

    def slice(self, k: int) -> "NttGuard":
        return self.take(np.arange(k))

    # -- probe construction ------------------------------------------------
    def transpose_probe(self, plan, probe_mont: jnp.ndarray) -> jnp.ndarray:
        """Mᵀu for an ARBITRARY probe: given u in Montgomery form (u·R,
        shape (..., L, n) stored values), return V_mont such that for all x

            Σ mont_mul(V_mont, x)  ==  Σ mont_mul(u_mont, plan.fwd(x))   (mod q)

        per limb — the projection <u, Mx> pushed through the transform at
        probe-BUILD time, so a runtime check of a whole linear pipeline
        (NTT → ⊙key → accumulate, fhe/protected.py's keyswitch-core check)
        needs only one modular dot against the INPUT.  Same Ĥ construction
        as `make` (module docstring): z = u[ν⁻¹]·ψ^{-t} (Montgomery algebra
        absorbs the R^{-1}), Û = fwd(z)[ν⁻¹], V_mont = Û·ψ^t·R²·R^{-1}."""
        qb = self.q_arr[:, None]
        qinvb = self.qinv_arr[:, None]
        z = u32.mont_mul(probe_mont[..., plan.nu_inv], self.psi_inv, qb, qinvb)
        u_hat = plan.fwd(z)[..., plan.nu_inv]
        return u32.mont_mul(u_hat, self.dmont, qb, qinvb)

    # -- runtime checks ----------------------------------------------------
    def _dot(self, w_mont: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        """<w, x> mod q per limb: (..., L, n) -> (..., L)."""
        qb = self.q_arr[:, None]
        qinvb = self.qinv_arr[:, None]
        prod = u32.mont_mul(w_mont, x, qb, qinvb)
        return sum_mod(prod, self.q_arr, axis=-1)

    def check_fwd(self, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
        """ok per limb for y = plan.fwd(x): (..., L) bool."""
        return self._dot(self.phi_mont, y) == self._dot(self.vf_mont, x)

    def check_inv(self, y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        """ok per limb for x = plan.inv(y)."""
        return self._dot(self.phi_mont, x) == self._dot(self.vi_mont, y)
