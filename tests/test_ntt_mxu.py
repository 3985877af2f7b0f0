"""Bit-exactness of the production NTT path (ops/const_matmul.py +
ops/ntt_mxu.py) against the host oracle and the Pease pipeline.

The plan plays the role of the batched radix-8 device NTT the reference
rides (reliability_test/ntt_test.cu:95) — same role (the hot transform
under every scheme op), different mapping (four-step as int8-digit
matmuls, reliability_test/four_step_ntt_prot.py:71-109 is the algorithmic
model).
"""
from functools import lru_cache

import numpy as np
import jax.numpy as jnp
import pytest

from rfhe_tpu.numth import PrimeCtx, find_ntt_primes, montgomery_constants
from rfhe_tpu.ops import ntt_pease
from rfhe_tpu.ops.const_matmul import ConstMatPlan
from rfhe_tpu.ops.ntt_mxu import MxuNttPlan


def _ref_matmul(a, b, q):
    return ((a.astype(object) @ b.astype(object)) % q).astype(np.uint32)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("bits", [20, 28, 30])
def test_const_matmul_exact(side, bits):
    rng = np.random.default_rng(0)
    primes = find_ntt_primes(256, bits, 2) + [40961]
    qinvs = [montgomery_constants(q, 32)[1] for q in primes]
    L, m, k, c = len(primes), 48, 64, 80
    if side == "left":
        W = np.stack([rng.integers(0, q, (m, k), dtype=np.uint32)
                      for q in primes])
        x = np.stack([rng.integers(0, q, (k, c), dtype=np.uint32)
                      for q in primes])
        ref = np.stack([_ref_matmul(W[l], x[l], primes[l]) for l in range(L)])
    else:
        W = np.stack([rng.integers(0, q, (k, m), dtype=np.uint32)
                      for q in primes])
        x = np.stack([rng.integers(0, q, (c, k), dtype=np.uint32)
                      for q in primes])
        ref = np.stack([_ref_matmul(x[l], W[l], primes[l]) for l in range(L)])
    plan = ConstMatPlan.make(W, primes, qinvs, side=side)
    got = np.asarray(plan.apply(jnp.asarray(x)))
    assert (got == ref).all()
    # leading batch dims broadcast
    xb = np.stack([x, x])
    gotb = np.asarray(plan.apply(jnp.asarray(xb)))
    assert (gotb[0] == ref).all() and (gotb[1] == ref).all()


def test_const_matmul_unpaired_big_k():
    """Contractions past the pairing bound fall back to per-digit groups."""
    rng = np.random.default_rng(1)
    primes = find_ntt_primes(1024, 30, 2)
    qinvs = [montgomery_constants(q, 32)[1] for q in primes]
    k = 512
    W = np.stack([rng.integers(0, q, (32, k), dtype=np.uint32)
                  for q in primes])
    x = np.stack([rng.integers(0, q, (k, 16), dtype=np.uint32)
                  for q in primes])
    plan = ConstMatPlan.make(W, primes, qinvs, side="left")
    got = np.asarray(plan.apply(jnp.asarray(x)))
    ref = np.stack([_ref_matmul(W[l], x[l], primes[l]) for l in range(2)])
    assert (got == ref).all()


@pytest.mark.parametrize("n", [16, 64, 128])
def test_mxu_ntt_vs_bruteforce(n):
    rng = np.random.default_rng(2)
    primes = find_ntt_primes(n, 24, 2) + find_ntt_primes(n, 18, 1)
    plan = MxuNttPlan.make(n, primes)
    x = np.stack([rng.integers(0, q, n, dtype=np.uint32) for q in primes])
    y = np.asarray(plan.fwd(jnp.asarray(x)))
    R = 1 << 32
    for l, q in enumerate(primes):
        psi = PrimeCtx.make(q, n).psi
        ref = np.array(
            [(sum(int(x[l][t]) * pow(psi, (t * (2 * k + 1)) % (2 * n), q)
                  for t in range(n)) * R) % q for k in range(n)],
            dtype=np.uint32)
        assert (y[l] == ref[plan.nu]).all()
    assert (np.asarray(plan.inv(jnp.asarray(y))) == x).all()


@pytest.mark.parametrize("n", [512, 4096])
def test_mxu_ntt_vs_pease(n):
    """Same transform as the Pease pipeline up to the slot-order maps."""
    rng = np.random.default_rng(3)
    primes = find_ntt_primes(n, 30, 3)
    mp = MxuNttPlan.make(n, primes)
    pp = ntt_pease.PeaseNttPlan.make(n, primes)
    x = np.stack([rng.integers(0, q, n, dtype=np.uint32) for q in primes])
    ym = np.asarray(mp.fwd(jnp.asarray(x)))
    yp = np.asarray(ntt_pease.negacyclic_ntt(jnp.asarray(x), pp))
    nat = np.empty_like(yp)
    nat[:, pp.nu] = yp                       # pease -> natural order
    assert (ym == nat[:, mp.nu]).all()
    assert (np.asarray(mp.inv(jnp.asarray(ym))) == x).all()
    # batched + sliced paths agree
    yb = np.asarray(mp.fwd(jnp.asarray(np.stack([x, x]))))
    assert (yb[1] == ym).all()
    sub = mp.take([0, 2])
    assert (np.asarray(sub.fwd(jnp.asarray(x[[0, 2]]))) == ym[[0, 2]]).all()


def test_mxu_galois_perm():
    """fwd(x(X^g)) == perm(fwd(x)) — the automorphism is a slot gather."""
    n, g = 64, 5
    q = find_ntt_primes(n, 20, 1)[0]
    plan = MxuNttPlan.make(n, [q])
    rng = np.random.default_rng(4)
    x = rng.integers(0, q, n, dtype=np.uint32)
    y = np.asarray(plan.fwd(jnp.asarray(x[None])))[0]
    xg = np.zeros(n, dtype=np.uint32)
    for t in range(n):                       # x(X^g) mod X^n + 1
        e = (t * g) % (2 * n)
        v = int(x[t])
        if e >= n:
            e -= n
            v = (q - v) % q
        xg[e] = (int(xg[e]) + v) % q
    yg = np.asarray(plan.fwd(jnp.asarray(xg[None])))[0]
    assert (yg == y[plan.galois_perm(g)]).all()


def test_dispatch_through_ntt_pease_module():
    """negacyclic_ntt/intt/galois_perm dispatch on the plan type."""
    n = 256
    primes = find_ntt_primes(n, 28, 2)
    mp = MxuNttPlan.make(n, primes)
    rng = np.random.default_rng(5)
    x = jnp.asarray(np.stack([rng.integers(0, q, n, dtype=np.uint32)
                              for q in primes]))
    y = ntt_pease.negacyclic_ntt(x, mp)
    assert (np.asarray(ntt_pease.negacyclic_intt(y, mp)) ==
            np.asarray(x)).all()
    assert (ntt_pease.galois_perm(mp, 5) == mp.galois_perm(5)).all()


@lru_cache(maxsize=None)
def _plans(n, bits):
    primes = find_ntt_primes(n, bits, 3)
    return primes, MxuNttPlan.make(n, primes), ntt_pease.PeaseNttPlan.make(
        n, primes)


def _vectors(kind, primes, n):
    """(3, L, n) batch of one adversarial kind: random draws, all q-1 (every
    partial product and carry at its maximum), or a lone q-1 spike."""
    qarr = np.asarray(primes, dtype=np.uint32)[:, None]
    rng = np.random.default_rng(6)
    if kind == "random":
        return np.stack([np.concatenate([rng.integers(0, q, (1, n),
                                                      dtype=np.uint32)
                                         for q in primes])
                         for _ in range(3)])
    if kind == "all_q_minus_1":
        return np.broadcast_to(qarr - 1, (3, len(primes), n)).copy()
    x = np.zeros((3, len(primes), n), dtype=np.uint32)
    for b, pos in enumerate((0, n // 2, n - 1)):
        x[b, :, pos] = (qarr - 1)[:, 0]
    return x


@pytest.mark.parametrize("kind", ["random", "all_q_minus_1", "spike"])
@pytest.mark.parametrize("bits", [30, 31])
@pytest.mark.parametrize("n", [256, 4096])
def test_mxu_ntt_adversarial(n, bits, kind):
    """fwd equals the Pease NTT through nu and inv round-trips, bit-exact,
    on the extreme inputs that data-dependent overflow bugs need."""
    primes, mp, pp = _plans(n, bits)
    x = _vectors(kind, primes, n)
    ym = np.asarray(mp.fwd(jnp.asarray(x)))
    yp = np.asarray(ntt_pease.negacyclic_ntt(jnp.asarray(x), pp))
    nat = np.empty_like(yp)
    nat[..., pp.nu] = yp
    assert (ym == nat[..., mp.nu]).all()
    assert (np.asarray(mp.inv(jnp.asarray(ym))) == x).all()
