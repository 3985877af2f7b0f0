"""Fault-injection primitives (L5): bit flips and multiplier-fault models as
pure JAX transforms on uint32 residue arrays, driven by jax.random keys so
campaigns vmap over trials with per-trial fold-in keys (replacing the
reference's per-thread mt19937 streams, four_step_ntt_protected.cpp:320).

Taxonomies implemented (SURVEY.md §5):
  SCF-BF / SCF-MBU      storage single-bit / multi-bit-upset flips
                        (four_step_ntt_protected.py:122-156)
  MCF-PPE / MCF-CTE / MCF-CLE  multiplier partial-product / carry-tree /
                        control-logic errors (:158-208)
  SBF / DBF / MOF1      single/double bit flip, randomize
                        (relia_ntt_sim.py:84-94)

All injectors corrupt exactly one element (except MCF-CLE-matrix, which
corrupts a row, matching :175-183) and wrap the corrupted value into [0, q)
the way the reference does ((x ^ mask) % q, relia_ntt_sim.py:77-82).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _wrap(v: jnp.ndarray, q: int) -> jnp.ndarray:
    # corrupted values are < 2^bitwidth <= 2q: one conditional subtract
    return jnp.where(v >= q, v - jnp.uint32(q), v)


def _set_flat(x_flat: jnp.ndarray, idx, value) -> jnp.ndarray:
    """flat.at[idx].set(value) in one-hot form.

    NOT a scatter: vmapped scatters with traced indices into a
    trial-invariant operand silently dropped updates at batch >= ~1024 on
    the first accelerator runtime this ran on (seen as impossible miss
    rates in the protected-evaluator campaign; see
    fhe/protected.py:_flip2).  Untested on the GPU; the campaign's
    check_row guards it.  The one-hot where() lowers to elementwise ops
    only."""
    onehot = jnp.arange(x_flat.shape[0]) == idx
    return jnp.where(onehot, value, x_flat)


def _scatter_xor_flat(x: jnp.ndarray, idx, mask, q: int) -> jnp.ndarray:
    """XOR `mask` into flat element `idx`, wrapping into [0, q)."""
    flat = x.reshape(-1)
    v = _wrap(flat[idx] ^ mask, q)
    return _set_flat(flat, idx, v).reshape(x.shape)


def inject_sbf(key, x: jnp.ndarray, q: int, bitwidth: int) -> jnp.ndarray:
    """Flip one random bit (< bitwidth) of one random element."""
    k1, k2 = jax.random.split(key)
    idx = jax.random.randint(k1, (), 0, x.size)
    b = jax.random.randint(k2, (), 0, bitwidth, dtype=jnp.uint32)
    return _scatter_xor_flat(x, idx, jnp.uint32(1) << b, q)


def inject_dbf(key, x: jnp.ndarray, q: int, bitwidth: int) -> jnp.ndarray:
    """Flip two independently-chosen random bits of one element (they may
    coincide, degenerating to SBF — matching relia_ntt_sim.py:89-91)."""
    k1, k2, k3 = jax.random.split(key, 3)
    idx = jax.random.randint(k1, (), 0, x.size)
    b1 = jax.random.randint(k2, (), 0, bitwidth, dtype=jnp.uint32)
    b2 = jax.random.randint(k3, (), 0, bitwidth, dtype=jnp.uint32)
    mask = jnp.where(b1 == b2, jnp.uint32(1) << b1,
                     (jnp.uint32(1) << b1) | (jnp.uint32(1) << b2))
    return _scatter_xor_flat(x, idx, mask, q)


def inject_mbu(key, x: jnp.ndarray, q: int, bitwidth: int,
               k_choices=(2, 3, 4)) -> jnp.ndarray:
    """SCF-MBU: flip K contiguous bits at a random start
    (four_step_ntt_protected.py:133-137)."""
    k1, k2, k3 = jax.random.split(key, 3)
    idx = jax.random.randint(k1, (), 0, x.size)
    kc = jnp.asarray(k_choices, dtype=jnp.uint32)
    K = kc[jax.random.randint(k2, (), 0, len(k_choices))]
    start = jax.random.randint(k3, (), 0, max(1, bitwidth - int(max(k_choices)) + 1),
                               dtype=jnp.uint32)
    mask = (((jnp.uint32(1) << K) - 1) << start)
    return _scatter_xor_flat(x, idx, mask, q)


def inject_mof1(key, x: jnp.ndarray, q: int) -> jnp.ndarray:
    """Randomize one element uniformly in [0, q)."""
    k1, k2 = jax.random.split(key)
    idx = jax.random.randint(k1, (), 0, x.size)
    v = jax.random.randint(k2, (), 0, q, dtype=jnp.uint32)
    return _set_flat(x.reshape(-1), idx, v).reshape(x.shape)


def inject_cte(key, x: jnp.ndarray, q: int, bitwidth: int) -> jnp.ndarray:
    """MCF-CTE: bit flip biased to the high half of the word
    (four_step_ntt_protected.py:171-173)."""
    k1, k2 = jax.random.split(key)
    idx = jax.random.randint(k1, (), 0, x.size)
    lo = max(1, bitwidth // 2)
    b = jax.random.randint(k2, (), lo, bitwidth, dtype=jnp.uint32)
    return _scatter_xor_flat(x, idx, jnp.uint32(1) << b, q)


def inject_cle_matrix(key, A: jnp.ndarray, B: jnp.ndarray, C: jnp.ndarray,
                      arith) -> jnp.ndarray:
    """MCF-CLE on a matmul result: a whole output row absorbs ±{1,2}·A[i,k0]·B[k0,:]
    (four_step_ntt_protected.py:175-183)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    rows = C.shape[-2]
    kdim = B.shape[-2]
    i = jax.random.randint(k1, (), 0, rows)
    k0 = jax.random.randint(k2, (), 0, kdim)
    mfac = jax.random.randint(k3, (), 1, 3, dtype=jnp.uint32)   # 1 or 2
    s = jax.random.bernoulli(k4)                                 # sign
    delta = arith.mul(A[..., i, k0], B[..., k0, :])
    delta = arith.mul(mfac, delta)
    row = C[..., i, :]
    new_row = jnp.where(s, arith.add(row, delta), arith.sub(row, delta))
    onehot = (jnp.arange(rows) == i)[:, None]          # see _set_flat note
    return jnp.where(onehot, new_row[..., None, :], C)


def inject_cle_vector(key, X: jnp.ndarray, T: jnp.ndarray, Y: jnp.ndarray,
                      mod: int) -> jnp.ndarray:
    """MCF-CLE on an elementwise product: Y[idx] = k·(X[idx]·T[idx]) mod M,
    k ∈ {-1, 2, -2} (four_step_ntt_protected.py:203-207)."""
    k1, k2 = jax.random.split(key)
    idx = jax.random.randint(k1, (), 0, Y.size)
    kk = jnp.asarray([mod - 1, 2, mod - 2], dtype=jnp.uint32)
    kv = kk[jax.random.randint(k2, (), 0, 3)]
    xf = X.reshape(-1)[idx]
    tf = T.reshape(-1)[idx]
    from ..ops.u32 import mul32_parts
    # k·x·t mod M computed exactly via 64-bit pairs + shift-subtract (M may be
    # composite, e.g. 2^W - 1, so the Montgomery path is unavailable).
    hi, lo = mul32_parts(xf, tf)
    hi, lo = _mod_u64(hi, lo, mod)
    hi2, lo2 = mul32_parts(lo, kv)
    _, r = _mod_u64(hi2, lo2, mod)
    return _set_flat(Y.reshape(-1), idx, r).reshape(Y.shape)


def _mod_u64(hi: jnp.ndarray, lo: jnp.ndarray, m: int):
    """(hi:lo) mod m for m < 2^31 via static shift-subtract (33 unrolled
    steps).  Used only in injection paths where m may be composite."""
    for s in range(32, -1, -1):
        # subtract m << s if (hi:lo) >= m << s
        ms = m << s
        ms_hi = jnp.uint32((ms >> 32) & 0xFFFFFFFF)
        ms_lo = jnp.uint32(ms & 0xFFFFFFFF)
        ge = (hi > ms_hi) | ((hi == ms_hi) & (lo >= ms_lo))
        borrow = (lo < ms_lo).astype(jnp.uint32)
        lo = jnp.where(ge, lo - ms_lo, lo)
        hi = jnp.where(ge, hi - ms_hi - borrow, hi)
    return hi, lo


KIND_SBF = "SBF"
KIND_DBF = "DBF"
KIND_MOF1 = "MOF1"

# integer kind codes shared by op-granularity injectors (the reference's
# FaultType enum, relia_ntt_sim.cpp:109-114 — NONE/SBF/DBF/MLF; DELTA is an
# rfhe_tpu extension used by tests to construct checksum cancellations)
CODE_NONE, CODE_SBF, CODE_DBF, CODE_MLF, CODE_DELTA = 0, 1, 2, 3, 4
SCENARIO_KINDS = {
    "SBF": (CODE_SBF,), "DBF": (CODE_DBF,), "MLF": (CODE_MLF,),
    "MOF1": (CODE_MLF,),          # element randomization == MLF at this grain
    "SBF+SBF": (CODE_SBF, CODE_SBF), "SBF+DBF": (CODE_SBF, CODE_DBF),
    "MLF+SBF": (CODE_MLF, CODE_SBF), "MLF+DBF": (CODE_MLF, CODE_DBF),
    "MLF+MLF": (CODE_MLF, CODE_MLF),
}


def inject_value(v: jnp.ndarray, kind, key, q: int, bits: int,
                 delta=0) -> jnp.ndarray:
    """Corrupt one scalar value by traced-or-static kind code; mirrors
    inject_one (relia_ntt_sim.cpp:118-132): SBF flips one random bit (<bits)
    then wraps mod q, DBF two distinct bits, MLF randomizes in [0, q),
    DELTA adds `delta` mod q."""
    k1, k2, k3 = jax.random.split(key, 3)
    b1 = jax.random.randint(k1, (), 0, bits, dtype=jnp.uint32)
    b2r = jax.random.randint(k2, (), 0, bits - 1, dtype=jnp.uint32)
    b2 = jnp.where(b2r >= b1, b2r + 1, b2r)
    sbf = _wrap(v ^ (jnp.uint32(1) << b1), q)
    dbf = _wrap(v ^ (jnp.uint32(1) << b1) ^ (jnp.uint32(1) << b2), q)
    mlf = jax.random.randint(k3, (), 0, q, dtype=jnp.uint32)
    s = v + jnp.uint32(delta)
    dl = jnp.where(s >= q, s - jnp.uint32(q), s)
    return jnp.select(
        [jnp.equal(kind, CODE_SBF), jnp.equal(kind, CODE_DBF),
         jnp.equal(kind, CODE_MLF), jnp.equal(kind, CODE_DELTA)],
        [sbf, dbf, mlf, dl], v)


def sample_distinct_indices(key, count: int, total) -> jnp.ndarray:
    """count ∈ {1, 2} distinct uniform indices in [0, total) (the reference
    resamples until distinct, relia_ntt_sim.cpp:441-447)."""
    if count == 1:
        return jax.random.randint(key, (1,), 0, total)
    assert count == 2, "reference scenarios inject at most 2 faults"
    k1, k2 = jax.random.split(key)
    o1 = jax.random.randint(k1, (), 0, total)
    o2 = jax.random.randint(k2, (), 0, total - 1)
    o2 = jnp.where(o2 >= o1, o2 + 1, o2)
    return jnp.stack([o1, o2])


def inject_elements(kind_codes, key, x: jnp.ndarray, q: int,
                    bits: int) -> jnp.ndarray:
    """Corrupt len(kind_codes) DISTINCT elements of x (multi-fault scenarios
    at storage granularity)."""
    flat = x.reshape(-1)
    ki, *kv = jax.random.split(key, len(kind_codes) + 1)
    idxs = sample_distinct_indices(ki, len(kind_codes), flat.size)
    for j, kc in enumerate(kind_codes):
        v = inject_value(flat[idxs[j]], kc, kv[j], q, bits)
        flat = _set_flat(flat, idxs[j], v)
    return flat.reshape(x.shape)


def inject_kind(kind: str, key, x: jnp.ndarray, q: int, bitwidth: int) -> jnp.ndarray:
    if kind == "SBF" or kind == "SCF-BF" or kind == "MCF-PPE":
        return inject_sbf(key, x, q, bitwidth)
    if kind == "DBF":
        return inject_dbf(key, x, q, bitwidth)
    if kind == "SCF-MBU":
        return inject_mbu(key, x, q, bitwidth)
    if kind == "MCF-CTE":
        return inject_cte(key, x, q, bitwidth)
    if kind == "MOF1" or kind == "MLF":
        # MLF (multi-line fault, relia_ntt_sim.cpp:129) randomizes the value
        # uniformly in [0, q) — identical to MOF1 at element granularity
        return inject_mof1(key, x, q)
    raise ValueError(f"unknown fault kind {kind}")
