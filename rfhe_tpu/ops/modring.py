"""ModArith: bundled modular-arithmetic context for one prime q < 2^31.

Thin convenience layer over ops.u32 providing overflow-safe reductions
(sums/dots mod q via halving trees — log-depth reductions that
never leave uint32).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..numth import montgomery_constants
from . import u32


@lru_cache(maxsize=1024)
def _plane_consts(shape, values):
    """Per-modulus constants for the 16-bit-plane sum: qinv_neg,
    2^48 mod q, 2^32 mod q (numpy arrays shaped like q)."""
    qs = np.asarray(values, dtype=np.uint64).reshape(shape)
    qinv = np.empty_like(qs, dtype=np.uint32)
    c48 = np.empty_like(qinv)
    c32 = np.empty_like(qinv)
    flat_q = qs.reshape(-1)
    fi = qinv.reshape(-1)
    f48 = c48.reshape(-1)
    f32 = c32.reshape(-1)
    for i, q in enumerate(flat_q):
        q = int(q)
        fi[i] = montgomery_constants(q, 32)[1]
        f48[i] = (1 << 48) % q
        f32[i] = (1 << 32) % q
    return qinv, c48, c32


def _q_key(qc: np.ndarray):
    return tuple(qc.shape), tuple(int(v) for v in qc.reshape(-1))


def sum_mod(x: jnp.ndarray, q, axis: int = -1) -> jnp.ndarray:
    """Modular sum along `axis`.

    `q` is a Python int or a uint32 array broadcastable to the result shape.
    Inputs must already be < q.

    Fast path (concrete q, axis length <= 2^16): the exact integer sum is
    assembled from two wide `jnp.sum` reduces over the 16-bit half-word
    planes (each plane sum < 2^32, so a single u32 reduce is exact), then
    folded mod q with two per-limb Montgomery products —
    S mod q = mont(s_hi, 2^48 mod q) + mont(s_lo, 2^32 mod q).  This
    replaces the log-depth halving tree, whose 12 sliced add_mod levels per
    call dominated the protected evaluator's checksum overhead (an earlier
    ablation on the previous accelerator found it almost entirely small-op
    launch cost).  Traced q falls back to the tree."""
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    q_conc = None
    if isinstance(q, (int, np.integer)):
        q_conc = np.asarray(q, dtype=np.uint64)
    elif not isinstance(q, jax.core.Tracer):
        try:
            q_conc = np.asarray(q, dtype=np.uint64)
        except Exception:
            q_conc = None
    if q_conc is not None and 1 < n <= (1 << 16):
        qinv, c48, c32 = _plane_consts(*_q_key(q_conc))
        s_lo = jnp.sum(x & jnp.uint32(0xFFFF), axis=-1, dtype=jnp.uint32)
        s_hi = jnp.sum(x >> 16, axis=-1, dtype=jnp.uint32)
        qb = jnp.asarray(q_conc.astype(np.uint32))
        hi_red = u32.mont_mul(s_hi, jnp.asarray(c48), qb, jnp.asarray(qinv))
        lo_red = u32.mont_mul(s_lo, jnp.asarray(c32), qb, jnp.asarray(qinv))
        return u32.add_mod(hi_red, lo_red, qb)
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, p - n)]
        x = jnp.pad(x, pad)
    qb = jnp.asarray(q, dtype=jnp.uint32)
    if qb.ndim:
        qb = qb[..., None]
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = u32.add_mod(x[..., :h], x[..., h:], qb)
    return x[..., 0]


@dataclass(frozen=True)
class ModArith:
    q: int
    qinv_neg: int
    r2: int

    @classmethod
    def make(cls, q: int) -> "ModArith":
        _, qinv_neg, r2 = montgomery_constants(q, 32)
        return cls(q=q, qinv_neg=qinv_neg, r2=r2)

    def add(self, a, b):
        return u32.add_mod(a, b, self.q)

    def sub(self, a, b):
        return u32.sub_mod(a, b, self.q)

    def neg(self, a):
        return u32.neg_mod(a, self.q)

    def mul(self, a, b):
        return u32.mul_mod(a, b, self.q, self.qinv_neg, self.r2)

    def mont_mul(self, a, b):
        return u32.mont_mul(a, b, self.q, self.qinv_neg)

    def to_mont(self, a):
        return u32.to_mont(a, self.q, self.qinv_neg, self.r2)

    def from_mont(self, a):
        return u32.from_mont(a, self.q, self.qinv_neg)

    def pow(self, a, e: int):
        return u32.pow_mod(a, e, self.q, self.qinv_neg, self.r2)

    def sum(self, x, axis: int = -1):
        return sum_mod(x, self.q, axis=axis)

    def dot(self, a, b, axis: int = -1):
        """<a, b> mod q (general operands: 2 mont_muls per element + tree sum)."""
        return self.sum(self.mul(a, b), axis=axis)
