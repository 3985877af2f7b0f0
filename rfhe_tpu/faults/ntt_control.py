"""Non-four-step (standard NTT) control campaign — the reference's control
experiment (rfhe_framewk/src/ntt_test/non_four_step_ntt_sim.cpp): a standard
radix-2 NTT protected only by

  LazyChecker     √n buckets, each accumulating the (actual, recomputed-true)
                  butterfly products keyed by global op index
                  (non_four_step_ntt_sim.cpp:135-158: accumulate at :146,
                  verify mod Q at :152).  A fault injected AT a multiply
                  desynchronizes its bucket (δ ≢ 0 mod Q) and is caught; a
                  storage fault BETWEEN ops corrupts the recomputed-true side
                  consistently and is invisible to the buckets.
  Global ABFT     random-projection <ŵ, x> == <w, NTT(x)> (:220-235), which
                  catches any corruption with probability 1 − 1/q.

This gives the paper's control comparison: without the four-step factorization
the layered detectors collapse to a single 1/q-collision projection for
storage faults (draw_non_4step_ntt.py figure).

Vectorized formulation: the reference walks butterflies one op at a time and
feeds a C++ LazyChecker; here each NTT stage is one vectorized butterfly pass
and the bucket state is a pair of (B,) mod-q accumulators updated per stage.
Because op ids advance block-major within a stage (matching the reference's
loop order) and B divides n/2, op_id % B == (index within stage) % B — the
per-stage bucket fold is a reshape + tree add_mod, no scatter needed.  Both
accumulators reduce mod q at every level, so the check is exactly the
reference's `sum % Q` comparison without 128-bit integers.

Fault model parity (non_four_step_ntt_sim.cpp:109-132, scenarios :265-269):
SBF / DBF (two distinct bits) / MLF (randomize) at chosen butterfly-multiply
op indices, plus the multi-fault combos SBF+SBF, SBF+DBF, MLF+SBF, MLF+DBF,
MLF+MLF with distinct op targets.  A DELTA kind (additive δ mod q) exists for
tests that need to construct bucket-internal cancellations.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.modring import ModArith
from ..ops.ntt import NttPlan, ntt
from ..ops.u32 import add_mod, sub_mod, mul_mod_shoup
from .inject import (
    CODE_DBF, CODE_DELTA, CODE_MLF, CODE_NONE, CODE_SBF, inject_kind,
    inject_value, sample_distinct_indices)

KIND_NONE, KIND_SBF, KIND_DBF, KIND_MLF, KIND_DELTA = (
    CODE_NONE, CODE_SBF, CODE_DBF, CODE_MLF, CODE_DELTA)

KIND_CODES = {"SBF": KIND_SBF, "DBF": KIND_DBF, "MLF": KIND_MLF,
              "DELTA": KIND_DELTA}

#: the reference's scenario table (non_four_step_ntt_sim.cpp:265-269)
SCENARIOS: Dict[str, Tuple[str, ...]] = {
    "SBF": ("SBF",), "DBF": ("DBF",), "MLF": ("MLF",),
    "SBF+SBF": ("SBF", "SBF"), "SBF+DBF": ("SBF", "DBF"),
    "MLF+SBF": ("MLF", "SBF"), "MLF+DBF": ("MLF", "DBF"),
    "MLF+MLF": ("MLF", "MLF"),
}


def lazy_num_buckets(n: int) -> int:
    """Largest power of two ≤ √n (the reference uses int(√n),
    non_four_step_ntt_sim.cpp:171; a power of two keeps the fold a reshape).
    Also clamped to n/2 so every bucket sees at least one op per stage."""
    b = 1 << ((n.bit_length() - 1) // 2)
    return max(1, min(b, n // 2))


def _fold_buckets(v_flat: jnp.ndarray, B: int, q: int) -> jnp.ndarray:
    """Σ over ops with the same (op_index % B), all sums kept in [0, q)."""
    rows = v_flat.reshape(-1, B)
    m = rows.shape[0]
    while m > 1:
        rows = add_mod(rows[: m // 2], rows[m // 2:], q)
        m //= 2
    return rows[0]


def ntt_standard_lazy(
    x: jnp.ndarray,
    plan: NttPlan,
    key,
    mult_ops: Optional[jnp.ndarray] = None,
    mult_kinds: Optional[jnp.ndarray] = None,
    mult_deltas: Optional[jnp.ndarray] = None,
    storage_stages: Optional[jnp.ndarray] = None,
    storage_kind: str = "SBF",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Standard DIF NTT over the last axis of a (n,) vector with the bucketed
    lazy-reduction checker threaded through every butterfly multiply.

    mult_ops/mult_kinds/(mult_deltas): (F,) arrays — fault f corrupts the
    product of global butterfly-op `mult_ops[f]` (block-major within stage,
    stages concatenated; -1 disables) with kind code `mult_kinds[f]`.
    storage_stages: (G,) array of stage indices (-1 = input, s = after stage
    s) where a `storage_kind` fault is written into the working array — these
    bypass the multiply path, so the checker's true side recomputes from the
    corrupted state and the buckets stay silent (the control result).

    Returns (y, lazy_ok) where lazy_ok is the computed bucket verification
    (non_four_step_ntt_sim.cpp:152-157), not a model.
    """
    n = plan.n
    q = plan.q
    log_n = n.bit_length() - 1
    hops = n // 2                       # multiply ops per stage
    bits = q.bit_length()
    B = lazy_num_buckets(n)
    shape = x.shape
    assert shape == (n,), "campaign trial operates on a single (n,) vector"

    F = 0 if mult_ops is None else int(mult_ops.shape[0])
    G = 0 if storage_stages is None else int(storage_stages.shape[0])
    nkeys = max(1, F + G)
    keys = jax.random.split(key, nkeys)

    bucket_out = jnp.zeros((B,), jnp.uint32)
    bucket_ref = jnp.zeros((B,), jnp.uint32)

    if G:
        for g in range(G):
            x = jnp.where(storage_stages[g] == -1,
                          inject_kind(storage_kind, keys[F + g], x, q, bits),
                          x)

    for s in range(log_n):
        m = n >> s
        half = m // 2
        xr = x.reshape(n // m, m)
        a = xr[..., :half]
        b = xr[..., half:]
        u = add_mod(a, b, q)
        w, ws = plan.stage_w(s)
        v_true = mul_mod_shoup(sub_mod(a, b, q), w, ws, q)
        v_flat = v_true.reshape(hops)
        vt_flat = v_flat
        for f in range(F):
            local = mult_ops[f] - s * hops
            in_stage = (local >= 0) & (local < hops)
            lc = jnp.clip(local, 0, hops - 1)
            delta = mult_deltas[f] if mult_deltas is not None else 0
            newv = inject_value(v_flat[lc], mult_kinds[f], keys[f], q, bits,
                                delta=delta)
            # one-hot update, not a scatter (see faults/inject.py:_set_flat)
            v_flat = jnp.where(in_stage & (jnp.arange(hops) == lc),
                               newv, v_flat)
        bucket_out = add_mod(bucket_out, _fold_buckets(v_flat, B, q), q)
        bucket_ref = add_mod(bucket_ref, _fold_buckets(vt_flat, B, q), q)
        x = jnp.concatenate(
            [u, v_flat.reshape(n // m, half)], axis=-1).reshape(shape)
        if G:
            for g in range(G):
                x = jnp.where(storage_stages[g] == s,
                              inject_kind(storage_kind, keys[F + g], x, q,
                                          bits),
                              x)

    lazy_ok = jnp.all(bucket_out == bucket_ref)
    return x, lazy_ok


def abft_global_check(x: jnp.ndarray, y: jnp.ndarray, plan: NttPlan,
                      arith: ModArith, key) -> jnp.ndarray:
    """Global ABFT: <w, y> == <(W·P)w, x> where P is the bit-reverse
    permutation of the DIF output; (W·P)w = bitrev(NTT(bitrev(w))) since W is
    symmetric and P an involution (check_abft_global,
    non_four_step_ntt_sim.cpp:220-235)."""
    from ..ops.ntt import bit_reverse_indices
    n = plan.n
    rev = jnp.asarray(bit_reverse_indices(n))
    w = jax.random.randint(key, (n,), 0, plan.q, dtype=jnp.uint32)
    w_hat = ntt(w[rev], plan)[rev]
    return arith.dot(w_hat, x) == arith.dot(w, y)


def standard_ntt_campaign(scenario: str, target: str, trials: int, n: int,
                          q: int, seed: int = 42) -> Dict:
    """Monte-Carlo control campaign.

    scenario: one of SCENARIOS (single faults and the reference's multi-fault
    combos).  target: 'mult' (faults at butterfly multiplies — LazyChecker
    territory) or 'storage' (faults written into the array between stages —
    only the global ABFT projection can see them).  Both run through the same
    checker pipeline; detection always comes from computed bucket state.
    """
    kinds = SCENARIOS[scenario]
    plan = NttPlan.make(n, q)
    arith = ModArith.make(q)
    log_n = n.bit_length() - 1
    total_ops = (n // 2) * log_n
    kind_codes = jnp.asarray([KIND_CODES[k] for k in kinds], dtype=jnp.int32)

    def trial(key):
        ks = jax.random.split(key, 4)
        x = jax.random.randint(ks[0], (n,), 0, q, dtype=jnp.uint32)
        y_clean = ntt(x, plan)
        if target == "mult":
            ops = sample_distinct_indices(ks[1], len(kinds), total_ops)
            y, lazy_ok = ntt_standard_lazy(
                x, plan, ks[2], mult_ops=ops, mult_kinds=kind_codes)
        else:
            stages = jax.random.randint(ks[1], (len(kinds),), -1, log_n)
            y, lazy_ok = ntt_standard_lazy(
                x, plan, ks[2], storage_stages=stages,
                storage_kind=kinds[0])
        abft_ok = abft_global_check(x, y, plan, arith, ks[3])
        harmful = jnp.any(y != y_clean)
        return harmful, ~lazy_ok, ~abft_ok

    keys = jax.random.split(jax.random.PRNGKey(seed), trials)
    harmful, lazy, abft = jax.jit(jax.vmap(trial))(keys)
    harmful = np.asarray(harmful)
    lazy = np.asarray(lazy)
    abft = np.asarray(abft)
    det = lazy | abft
    miss = float((harmful & ~det).sum() / max(1, harmful.sum()))
    return {
        "scenario": scenario,
        "target": target,
        "miss_rate": miss,
        "det_rate": float((harmful & det).sum() / max(1, harmful.sum())),
        "harmful": int(harmful.sum()),
        "lazy_catch": int((harmful & lazy).sum()),
        "abft_catch": int((harmful & abft & ~lazy).sum()),
        "abft_only_miss": float((harmful & ~abft).sum() /
                                max(1, harmful.sum())),
    }
