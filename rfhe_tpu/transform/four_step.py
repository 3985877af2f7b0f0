"""Four-step NTT as batched modular matmuls (single-chip; mesh version in
transform/distributed.py).

  a[t1 + n1*t2]  →  A[t2, t1]                (reshape, no data movement)
  stage 1:  B = W2 @ A                       (n2-point NTTs down columns)
  twiddle:  B *= T,  T[k2, t1] = ω^(t1·k2)   (elementwise, Shoup consts)
  stage 2:  Y = B @ W1ᵀ                      (n1-point NTTs along rows)
  y[k1*n2 + k2] = Y[k2, k1]                  (transpose + reshape)

This is the reference's flagship protected pipeline
(rfhe_framewk/src/ntt_test/relia_ntt_sim.py:223-278,
reliability_test/four_step_ntt_prot.py:71-109) re-shaped so that both NTT
stages are dense modular matmuls (ops/matmul_mod.py), and the
twiddle stage is a vectorized Shoup multiply — exactly the three-stage
matmul→elementwise→matmul structure the reference's checksum algebra
protects (four_step_ntt_protected.py:219-281).

Output is natural order, matching oracle.four_step_ntt == oracle.ntt_direct.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..numth import PrimeCtx, montgomery_constants, root_of_unity, shoup_precompute
from ..ops.matmul_mod import DigitPlan, matmul_mod
from ..ops.modring import ModArith
from ..ops.u32 import mul_mod_shoup


def _ntt_matrix(m: int, root: int, q: int) -> np.ndarray:
    """Dense m×m NTT matrix W[r, c] = root^(r*c) mod q."""
    W = np.empty((m, m), dtype=np.uint32)
    for r in range(m):
        v = 1
        wr = pow(root, r, q)
        for c in range(m):
            W[r, c] = v
            v = (v * wr) % q
    return W


@dataclass(frozen=True)
class FourStepPlan:
    n: int
    n1: int
    n2: int
    q: int
    arith: ModArith
    digit: DigitPlan
    W2: jnp.ndarray        # (n2, n2) stage-1 NTT matrix (root of order n2)
    W1T: jnp.ndarray       # (n1, n1) stage-2 NTT matrix, pre-transposed
    T: jnp.ndarray         # (n2, n1) twiddle ω^(t1·k2)
    T_shoup: jnp.ndarray
    # inverse-path tables
    W2i: jnp.ndarray
    W1Ti: jnp.ndarray
    Ti: jnp.ndarray        # inverse twiddle, with n^{-1} folded in
    Ti_shoup: jnp.ndarray

    @classmethod
    def make(cls, n: int, q: int, path: str = "int8") -> "FourStepPlan":
        log_n = n.bit_length() - 1
        assert (1 << log_n) == n
        n1 = 1 << (log_n // 2)
        n2 = n // n1
        omega = root_of_unity(n, q)
        omega_inv = pow(omega, q - 2, q)
        w_n1 = pow(omega, n1, q)   # order n2
        w_n2 = pow(omega, n2, q)   # order n1
        arith = ModArith.make(q)
        digit = DigitPlan.make(q, arith.qinv_neg, path)
        W2 = _ntt_matrix(n2, w_n1, q)
        W1 = _ntt_matrix(n1, w_n2, q)
        W2i = _ntt_matrix(n2, pow(w_n1, q - 2, q), q)
        W1i = _ntt_matrix(n1, pow(w_n2, q - 2, q), q)
        T = np.empty((n2, n1), dtype=np.uint32)
        Ti = np.empty((n2, n1), dtype=np.uint32)
        n_inv = pow(n, q - 2, q)
        for k2 in range(n2):
            for t1 in range(n1):
                T[k2, t1] = pow(omega, (t1 * k2) % n, q)
                Ti[k2, t1] = (pow(omega_inv, (t1 * k2) % n, q) * n_inv) % q
        Ts = np.vectorize(lambda w: shoup_precompute(int(w), q))(T).astype(np.uint32)
        Tis = np.vectorize(lambda w: shoup_precompute(int(w), q))(Ti).astype(np.uint32)
        return cls(
            n=n, n1=n1, n2=n2, q=q, arith=arith, digit=digit,
            W2=jnp.asarray(W2), W1T=jnp.asarray(W1.T.copy()),
            T=jnp.asarray(T), T_shoup=jnp.asarray(Ts),
            W2i=jnp.asarray(W2i), W1Ti=jnp.asarray(W1i.T.copy()),
            Ti=jnp.asarray(Ti), Ti_shoup=jnp.asarray(Tis),
        )


def _to_matrix(x: jnp.ndarray, plan: FourStepPlan) -> jnp.ndarray:
    return x.reshape(x.shape[:-1] + (plan.n2, plan.n1))


def _from_matrix(Y: jnp.ndarray, plan: FourStepPlan) -> jnp.ndarray:
    out = jnp.swapaxes(Y, -1, -2)  # (n1, n2): out[k1, k2]
    return out.reshape(out.shape[:-2] + (plan.n,))


def four_step_ntt(x: jnp.ndarray, plan: FourStepPlan) -> jnp.ndarray:
    """Forward cyclic NTT over the last axis (natural order in/out)."""
    A = _to_matrix(x, plan)
    B = matmul_mod(plan.W2, A, plan.digit)
    B = mul_mod_shoup(B, plan.T, plan.T_shoup, plan.q)
    Y = matmul_mod(B, plan.W1T, plan.digit)
    return _from_matrix(Y, plan)


def four_step_intt(y: jnp.ndarray, plan: FourStepPlan) -> jnp.ndarray:
    """Inverse of four_step_ntt (includes 1/n scaling, via the Ti table)."""
    Y = jnp.swapaxes(y.reshape(y.shape[:-1] + (plan.n1, plan.n2)), -1, -2)
    B = matmul_mod(Y, plan.W1Ti, plan.digit)
    B = mul_mod_shoup(B, plan.Ti, plan.Ti_shoup, plan.q)
    A = matmul_mod(plan.W2i, B, plan.digit)
    return A.reshape(y.shape[:-1] + (plan.n,))


def four_step_ntt_stages(x: jnp.ndarray, plan: FourStepPlan):
    """Forward transform exposing per-stage tensors (A, B1, B2, Y) for the
    detector layer (protect/) and fault-injection hooks (faults/)."""
    A = _to_matrix(x, plan)
    B1 = matmul_mod(plan.W2, A, plan.digit)
    B2 = mul_mod_shoup(B1, plan.T, plan.T_shoup, plan.q)
    Y = matmul_mod(B2, plan.W1T, plan.digit)
    return A, B1, B2, Y
