"""Mesh-sharded four-step NTT: the scale-out transform (SP analog).

The n2×n1 coefficient matrix shards its t1 (column) axis over the mesh:
stage-1 column NTTs and the twiddle multiply are embarrassingly local; the
stage-1→stage-2 transpose is ONE `all_to_all` between devices; stage-2 row NTTs are
local again.  Checksums reduce with `all_gather`+tree-sum (exact mod-q sums;
a raw psum could overflow uint32).

This is the counterpart of what the reference lacks entirely
(SURVEY.md §2.6: reference parallelism = OpenMP trials + CUDA batching); the
structural analog in the reference is the four-step factorization itself
(reliability_test/four_step_ntt_prot.py:71-109), which we distribute the way
ring/Ulysses attention distributes long sequences.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.4.35 exposes shard_map at top level
    from jax import shard_map as _shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map

from ..ops.matmul_mod import matmul_mod
from ..ops.modring import sum_mod
from ..ops.u32 import mul_mod_shoup
from .four_step import FourStepPlan


def make_mesh(n_devices: int | None = None, axis: str = "fft") -> Mesh:
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    return Mesh(np.array(devs[:n_devices]), (axis,))


class ShardedCheckResult(NamedTuple):
    y: jnp.ndarray
    batch1_ok: jnp.ndarray
    inter_ok: jnp.ndarray
    batch2_ok: jnp.ndarray


def _allsum_mod(x: jnp.ndarray, q: int, axis_name: str) -> jnp.ndarray:
    """Exact modular sum across the mesh axis: gather the D partial sums and
    tree-reduce them mod q (values stay < q in uint32 throughout)."""
    g = jax.lax.all_gather(x, axis_name)          # (D, ...)
    return sum_mod(g, q, axis=0)


def _lead_spec(nd: int, batch_axis, *tail):
    """PartitionSpec with `tail` on the last len(tail) dims and batch_axis
    (if any) on dim 0."""
    lead = [batch_axis] + [None] * (nd - len(tail) - 1)
    return P(*(lead[:nd - len(tail)] + list(tail)))


def four_step_ntt_sharded(x: jnp.ndarray, plan: FourStepPlan, mesh: Mesh,
                          axis: str = "fft",
                          batch_axis: str | None = None) -> jnp.ndarray:
    """Forward cyclic NTT over the last axis, t1 sharded over `axis`; an
    optional leading batch dim (RNS limbs / ciphertext polys — the DP analog)
    shards over `batch_axis`.

    x: (..., n).  Output natural order, identical to transform.four_step_ntt.
    """
    D = mesh.shape[axis]
    assert plan.n1 % D == 0 and plan.n2 % D == 0

    def local(xm, T, Ts):
        # xm: (..., n2, n1/D) local block
        B = matmul_mod(plan.W2, xm, plan.digit)
        B = mul_mod_shoup(B, T, Ts, plan.q)
        # transpose between devices: split n2, concat n1 -> (..., n2/D, n1)
        B = jax.lax.all_to_all(B, axis, split_axis=B.ndim - 2,
                               concat_axis=B.ndim - 1, tiled=True)
        Y = matmul_mod(B, plan.W1T, plan.digit)
        return Y                                   # (..., n2/D, n1)

    A = x.reshape(x.shape[:-1] + (plan.n2, plan.n1))
    nd = A.ndim
    f = _shard_map(
        local, mesh=mesh,
        in_specs=(_lead_spec(nd, batch_axis, None, axis), P(None, axis),
                  P(None, axis)),
        out_specs=_lead_spec(nd, batch_axis, axis, None))
    Y = f(A, plan.T, plan.T_shoup)
    out = jnp.swapaxes(Y, -1, -2)
    return out.reshape(x.shape[:-1] + (plan.n,))


def four_step_intt_sharded(y: jnp.ndarray, plan: FourStepPlan, mesh: Mesh,
                           axis: str = "fft",
                           batch_axis: str | None = None) -> jnp.ndarray:
    """Inverse of four_step_ntt_sharded (includes 1/n).  Mirrors the forward
    dataflow so a forward→pointwise→inverse pipeline does exactly two
    all_to_all transposes total."""
    D = mesh.shape[axis]
    assert plan.n1 % D == 0 and plan.n2 % D == 0

    def local(Ym, Ti, Tis):
        # Ym: (..., n2/D, n1): row INTTs are local
        B = matmul_mod(Ym, plan.W1Ti, plan.digit)
        B = mul_mod_shoup(B, Ti, Tis, plan.q)
        # transpose back: split n1, concat n2 -> (..., n2, n1/D)
        B = jax.lax.all_to_all(B, axis, split_axis=B.ndim - 1,
                               concat_axis=B.ndim - 2, tiled=True)
        A = matmul_mod(plan.W2i, B, plan.digit)
        return A                                   # (..., n2, n1/D)

    Y = jnp.swapaxes(y.reshape(y.shape[:-1] + (plan.n1, plan.n2)), -1, -2)
    nd = Y.ndim
    f = _shard_map(
        local, mesh=mesh,
        in_specs=(_lead_spec(nd, batch_axis, axis, None), P(axis, None),
                  P(axis, None)),
        out_specs=_lead_spec(nd, batch_axis, None, axis))
    A = f(Y, plan.Ti, plan.Ti_shoup)
    return A.reshape(y.shape[:-1] + (plan.n,))


def four_step_ntt_sharded_protected(x: jnp.ndarray, plan: FourStepPlan,
                                    mesh: Mesh, key,
                                    axis: str = "fft") -> ShardedCheckResult:
    """Sharded forward NTT with the three cross-shard ABFT detectors riding
    the collectives: stage projections and the twiddle inter-check become
    all_gather + tree-sums of per-shard partial checksums."""
    D = mesh.shape[axis]
    assert plan.n1 % D == 0 and plan.n2 % D == 0
    q = plan.q
    k1, k2, k3 = jax.random.split(key, 3)
    w1 = jax.random.randint(k1, (plan.n2,), 0, q, dtype=jnp.uint32)
    phi = jax.random.randint(k2, (plan.n2,), 0, q, dtype=jnp.uint32)
    w2 = jax.random.randint(k3, (plan.n1,), 0, q, dtype=jnp.uint32)
    w1_hat = matmul_mod(plan.W2, w1[:, None], plan.digit)[:, 0]
    w2_hat = matmul_mod(plan.W1T.T, w2[:, None], plan.digit)[:, 0]

    ar = plan.arith

    def local(A, T, Ts, w1, w1_hat, phi, w2, w2_hat):
        # A: (n2, n1/D)
        B1 = matmul_mod(plan.W2, A, plan.digit)
        # stage-1 projection: row sums are sums over the sharded t1 axis
        s_in = _allsum_mod(sum_mod(A, q, axis=-1), q, axis)
        s_out = _allsum_mod(sum_mod(B1, q, axis=-1), q, axis)
        b1_ok = ar.dot(w1_hat, s_in) == ar.dot(w1, s_out)
        # twiddle (local) + inter check partial sums over local columns
        B2 = mul_mod_shoup(B1, T, Ts, q)
        lhs = _allsum_mod(sum_mod(B2, q, axis=-1), q, axis)
        rhs = _allsum_mod(sum_mod(ar.mul(T, B1), q, axis=-1), q, axis)
        inter_ok = ar.dot(phi, lhs) == ar.dot(phi, rhs)
        # stage-2: transpose then row NTTs; column sums now span shards of n2
        Bt = jax.lax.all_to_all(B2, axis, split_axis=0, concat_axis=1,
                                tiled=True)       # (n2/D, n1)
        Y = matmul_mod(Bt, plan.W1T, plan.digit)
        r_in = _allsum_mod(sum_mod(Bt, q, axis=-2), q, axis)
        r_out = _allsum_mod(sum_mod(Y, q, axis=-2), q, axis)
        b2_ok = ar.dot(w2_hat, r_in) == ar.dot(w2, r_out)
        return Y, b1_ok, inter_ok, b2_ok

    A = x.reshape(plan.n2, plan.n1)
    f = _shard_map(
        local, mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(None, axis),
                  P(None), P(None), P(None), P(None), P(None)),
        out_specs=(P(axis, None), P(), P(), P()),
        check_vma=False,  # check booleans are replicated via all_gather sums
    )
    Y, b1, inter, b2 = f(A, plan.T, plan.T_shoup, w1, w1_hat, phi, w2, w2_hat)
    y = jnp.swapaxes(Y, -1, -2).reshape(plan.n)
    return ShardedCheckResult(y=y, batch1_ok=b1, inter_ok=inter, batch2_ok=b2)
