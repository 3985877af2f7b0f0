"""Four-step negacyclic NTT as two int8-digit matmuls (the production path).

An n-point NTT factors as n2 column-NTTs + twiddle + n1 row-NTTs
(n = n1*n2; the reference's flagship pipeline,
rfhe_framewk/src/ntt_test/relia_ntt_sim.py:223-278 and
reliability_test/four_step_ntt_prot.py:71-109).  Both NTT stages are dense
modular matmuls: instead of (n/2)·log2 n elementwise butterfly sweeps with
a device-memory round-trip per stage (ops/ntt_pease.py), we do two
int8-digit integer matmuls (ops/const_matmul.py) with contraction
~5·sqrt(n).  Everything else folds into constant tables:

  negacyclic twist  ψ^t = ψ^(t1) · ψ^(n1·t2):  the t2 factor multiplies the
    stage-1 matrix columns, the t1 factor multiplies the twiddle table —
    the ψ pre/post-multiply costs ZERO extra work;
  Montgomery form: NTT-domain slots carry R = 2^32 (so dyadic ciphertext
    products are single mont_muls); R folds into the forward twiddle and
    R^{-1}·n^{-1} into the inverse twiddle;
  the twiddle itself folds into the stage-1 digit recombination: instead of
    scalar Montgomery group weights 2^(8i)·R followed by an elementwise
    twiddle multiply, the recombination uses per-element weight tables
    U_g[k2,t1] = 2^(8i)·T[k2,t1]·R mod q — same op count as the scalar
    recombination, so the twiddle stage vanishes.  (With R = 2^32 the
    negative-accumulator fix constant 2^32·U·R^{-1} equals U itself.)

Slot order: slot p = k2·n1 + k1 holds NTT coefficient k = k1·n2 + k2
(m(ψ^(2k+1))·R), i.e. the RAW stage-2 output layout.  With this choice both
directions are completely transpose-free: every stage contracts the last or
second-to-last axis of the (..., L, n2, n1)-shaped data in place, and the
inverse's natural contraction order (k1 first, then k2) lands coefficients
back in row-major (t2, t1) = x[t1 + n1·t2] layout exactly.  Order-dependent
consumers (galois automorphisms) read plan.nu.

Forward (x natural coeffs, x[t1 + n1*t2] = A[t2, t1]):
  B  = W2f @ A          W2f[k2,t2] = ω_{n2}^(k2·t2) · ψ^(n1·t2)   [axis -2]
  B *= T·ψ^(t1)·R       (folded into stage-1 recombination)
  Y  = B @ W1Tf         W1Tf[t1,k1] = ω_{n1}^(t1·k1)              [axis -1]
  slot (k2, k1) = Y[k2, k1]

Inverse mirrors it with ω→ω^{-1}, ψ→ψ^{-1} and n^{-1}·R^{-1} in the folded
twiddle: contract k1 (W1Tif), twiddle, contract k2 (W2if) → A[t2, t1].
Bit-exact vs the Pease pipeline up to slot order (tests/test_ntt_mxu.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..numth import PrimeCtx, mod_inv
from .const_matmul import ConstMatPlan
from .u32 import add_mod, mont_mul, sub_mod

__all__ = ["MxuNttPlan"]

def _pow_table(base: int, count: int, q: int) -> np.ndarray:
    out = np.empty(count, dtype=np.uint64)
    v = 1
    for i in range(count):
        out[i] = v
        v = (v * base) % q
    return out


@dataclass(frozen=True)
class MxuNttPlan:
    """Stacked-limb four-step NTT tables.  Protocol-compatible with
    PeaseNttPlan: q_arr/qinv_arr/qb/qinvb/L/n/nu/nu_inv/slice/take, consumed
    through ops.ntt_pease.negacyclic_ntt/intt (which dispatch here)."""

    n: int
    n1: int
    n2: int
    q_arr: jnp.ndarray             # (L,)
    qinv_arr: jnp.ndarray
    s1: ConstMatPlan               # forward stage 1 (left,  (L, n2, n2))
    s2: ConstMatPlan               # forward stage 2 (right, (L, n1, n1))
    Uf: jnp.ndarray                # (G1, L, n2, n1) folded fwd twiddle weights
    s1i: ConstMatPlan              # inverse first stage (right, over k1)
    s2i: ConstMatPlan              # inverse second stage (left, over k2)
    Ui: jnp.ndarray                # (Gi, L, n2, n1) folded inv twiddle weights
    nu: np.ndarray                 # slot p -> NTT coefficient index
    nu_inv: np.ndarray

    @classmethod
    def make(cls, n: int, primes) -> "MxuNttPlan":
        primes = [int(q) for q in primes]
        L = len(primes)
        log_n = n.bit_length() - 1
        assert (1 << log_n) == n and n >= 4
        # split rule: balanced minimizes MACs (∝ n1+n2), with n1 >= 128 when
        # n allows.  The 128 floor is inherited from the first accelerator
        # target (a 128-wide last axis); it is not measured on the GPU.  It
        # stays because the split fixes the slot order (nu) that galois
        # permutations, keys and serialized slots depend on.
        n1 = 1 << (log_n // 2)
        if n1 < 128:
            n1 = min(128, 1 << (log_n - 1))
        n2 = n // n1
        R = 1 << 32
        W2f = np.empty((L, n2, n2), dtype=np.uint32)
        W1Tf = np.empty((L, n1, n1), dtype=np.uint32)
        Tf = np.empty((L, n2, n1), dtype=np.uint64)
        W1Tif = np.empty((L, n1, n1), dtype=np.uint32)
        W2if = np.empty((L, n2, n2), dtype=np.uint32)
        Ti = np.empty((L, n2, n1), dtype=np.uint64)
        q_arr = np.empty(L, dtype=np.uint32)
        qinv_arr = np.empty(L, dtype=np.uint32)
        k2g, t2g = np.meshgrid(np.arange(n2), np.arange(n2), indexing="ij")
        t1g, k1g = np.meshgrid(np.arange(n1), np.arange(n1), indexing="ij")
        k2t, t1t = np.meshgrid(np.arange(n2), np.arange(n1), indexing="ij")
        for li, q in enumerate(primes):
            ctx = PrimeCtx.make(q, n)
            w, psi = ctx.omega, ctx.psi
            wi, psii = mod_inv(w, q), mod_inv(psi, q)
            pw = _pow_table(w, n, q)
            pwi = _pow_table(wi, n, q)
            w_n2 = pow(w, n1, q)                # order n2
            w_n1 = pow(w, n2, q)                # order n1
            p2 = _pow_table(w_n2, n2, q)
            p2i = _pow_table(mod_inv(w_n2, q), n2, q)
            p1 = _pow_table(w_n1, n1, q)
            p1i = _pow_table(mod_inv(w_n1, q), n1, q)
            psi_n1 = _pow_table(pow(psi, n1, q), n2, q)      # ψ^(n1·t2)
            psi_t1 = _pow_table(psi, n1, q)                  # ψ^(t1)
            psii_n1 = _pow_table(pow(psii, n1, q), n2, q)
            psii_t1 = _pow_table(psii, n1, q)
            W2f[li] = (p2[(k2g * t2g) % n2] * psi_n1[t2g]) % q
            W1Tf[li] = p1[(t1g * k1g) % n1].astype(np.uint32)
            Tf[li] = pw[(k2t * t1t) % n] * psi_t1[t1t] % q * (R % q) % q
            # inverse right-matrix over k1 (ω^{-k1·t1} is symmetric in k1,t1)
            W1Tif[li] = p1i[(t1g * k1g) % n1].astype(np.uint32)
            # inverse stage over k2: A[t2,:] = Σ_k2 W2if[t2,k2]·B[k2,:] with
            # the ψ^{-n1·t2} exit factor on the output rows
            W2if[li] = (p2i[(k2g * t2g) % n2] * psii_n1[k2g]) % q
            n_inv = mod_inv(n, q)
            rinv = mod_inv(R % q, q)
            Ti[li] = (pwi[(k2t * t1t) % n] * psii_t1[t1t] % q
                      * (n_inv * rinv % q)) % q
            q_arr[li] = q
            qinv_arr[li] = ctx.qinv_neg
        qs = primes
        qinvs = [int(x) for x in qinv_arr]
        s1 = ConstMatPlan.make(W2f, qs, qinvs, side="left")
        s1i = ConstMatPlan.make(W1Tif, qs, qinvs, side="right")
        # folded twiddle recombination weights: U_g = 2^(8·start)·T·R mod q
        def folded(T, plan):
            G = len(plan.group_starts)
            U = np.empty((G,) + T.shape, dtype=np.uint32)
            for g, start in enumerate(plan.group_starts):
                for li, q in enumerate(qs):
                    c = pow(2, 8 * start + 32, q)
                    U[g, li] = (T[li] * c) % q
            return U
        # slot order: p = k2·n1 + k1 holds NTT coefficient k = k1·n2 + k2
        # (the raw stage-2 output layout — this choice makes BOTH directions
        # transpose-free; anything order-dependent consumes nu)
        p = np.arange(n, dtype=np.int64)
        nu = (p % n1) * n2 + p // n1
        nu_inv = np.empty(n, dtype=np.int64)
        nu_inv[nu] = p
        s2 = ConstMatPlan.make(W1Tf, qs, qinvs, side="right")
        s2i = ConstMatPlan.make(W2if, qs, qinvs, side="left")
        return cls(
            n=n, n1=n1, n2=n2,
            q_arr=jnp.asarray(q_arr), qinv_arr=jnp.asarray(qinv_arr),
            s1=s1, s2=s2, Uf=jnp.asarray(folded(Tf, s1)),
            s1i=s1i, s2i=s2i, Ui=jnp.asarray(folded(Ti, s1i)),
            nu=nu, nu_inv=nu_inv,
        )

    # ---- PeaseNttPlan protocol ------------------------------------------
    @property
    def L(self) -> int:
        return int(self.q_arr.shape[0])

    def qb(self, ndim: int):
        return self.q_arr.reshape((self.L,) + (1,) * ndim)

    def qinvb(self, ndim: int):
        return self.qinv_arr.reshape((self.L,) + (1,) * ndim)

    def galois_perm(self, g: int) -> np.ndarray:
        return _galois_perm_mxu(self.n, self.n1, g)

    def slice(self, k: int) -> "MxuNttPlan":
        return self.take(np.arange(k))

    def take(self, idx) -> "MxuNttPlan":
        idx = np.asarray(idx)
        return MxuNttPlan(
            n=self.n, n1=self.n1, n2=self.n2,
            q_arr=self.q_arr[idx], qinv_arr=self.qinv_arr[idx],
            s1=self.s1.take(idx), s2=self.s2.take(idx), Uf=self.Uf[:, idx],
            s1i=self.s1i.take(idx), s2i=self.s2i.take(idx),
            Ui=self.Ui[:, idx], nu=self.nu, nu_inv=self.nu_inv,
        )

    def _twiddle_recombine(self, groups, U, qb, qinvb):
        """Montgomery recombination with per-element folded twiddle weights.
        groups: int32 (..., L, n2, n1); U: (G, L, n2, n1) — broadcasts over
        leading batch dims in place."""
        acc = None
        for gi, g in enumerate(groups):
            u = U[gi]
            term = mont_mul(g.astype(jnp.uint32), u, qb, qinvb)
            term = sub_mod(term, jnp.where(g < 0, u, jnp.uint32(0)), qb)
            acc = term if acc is None else add_mod(acc, term, qb)
        return acc

    # ---- transforms -------------------------------------------------------
    def fwd(self, x: jnp.ndarray) -> jnp.ndarray:
        """Negacyclic forward NTT: x (..., L, n) plain coeffs ->
        (..., L, n) slots (order nu) in Montgomery form.  Transpose-free:
        both stages contract in the (..., L, n2, n1) layout."""
        n, n1, n2 = self.n, self.n1, self.n2
        shape = x.shape
        A = x.reshape(shape[:-1] + (n2, n1))                 # A[t2, t1]
        parts = self.s1.digit_groups(A)                      # (..., L, n2, n1)
        Bm = self._twiddle_recombine(parts, self.Uf, self.qb(2), self.qinvb(2))
        # stage boundary: XLA:CPU's fusion pass is pathologically slow
        # (~200 s) on the fused left-matmul -> digitize -> right-matmul
        # graph; the barrier costs nothing (stage outputs materialize anyway)
        Bm = jax.lax.optimization_barrier(Bm)
        Y = self.s2.apply(Bm)                                # (..., L, n2, n1)
        return Y.reshape(shape)                              # Y[k2, k1]

    def inv(self, y: jnp.ndarray) -> jnp.ndarray:
        """Inverse: slots (order nu, Montgomery) -> plain coeffs."""
        n, n1, n2 = self.n, self.n1, self.n2
        shape = y.shape
        Y = y.reshape(shape[:-1] + (n2, n1))                 # Y[k2, k1]
        parts = self.s1i.digit_groups(Y)                     # contract k1
        D = self._twiddle_recombine(parts, self.Ui, self.qb(2), self.qinvb(2))
        D = jax.lax.optimization_barrier(D)                  # see fwd note
        A = self.s2i.apply(D)                                # contract k2
        return A.reshape(shape)                              # A[t2, t1]


@lru_cache(maxsize=2048)
def _galois_perm_mxu(n: int, n1: int, g: int) -> np.ndarray:
    """Slot permutation for X -> X^g: slot p evaluates m at ψ^(2·nu[p]+1);
    the automorphism pulls from the slot holding exponent g·(2·nu[p]+1)
    mod 2n."""
    n2 = n // n1
    p = np.arange(n, dtype=np.int64)
    nu = (p % n1) * n2 + p // n1
    nu_inv = np.empty(n, dtype=np.int64)
    nu_inv[nu] = p
    e = (g * (2 * nu + 1)) % (2 * n)
    return nu_inv[(e - 1) // 2].astype(np.int32)
