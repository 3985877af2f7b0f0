"""Monte-Carlo fault-injection campaigns (L5), vmapped on-device.

Replaces the reference's OpenMP trial loops
(four_step_ntt_protected.cpp:306-338, relia_ntt_sim.cpp:437-466) with
jit(vmap(trial)) over per-trial PRNG keys: thousands of trials execute as one
batched device program (stage matmuls become batched device matmuls).

Campaigns:
  three_stage_campaign   matmul → elementwise-fold → matmul pipeline with
                         SCF/MCF fault taxonomy and per-stage collision
                         probabilities (four_step_ntt_protected.py:219-297)
  four_step_ntt_campaign the flagship protected four-step NTT with 4 layered
                         detectors and op-count-weighted stage selection
                         (relia_ntt_sim.py:223-315)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.matmul_mod import DigitPlan, matmul_mod
from ..ops.modring import ModArith
from ..ops.u32 import mul32_parts, mul_mod_shoup
from ..protect.checks import (
    elementwise_fold_check,
    matmul_check,
    stage1_projection_check,
    stage2_projection_check,
    twiddle_inter_check,
)
from ..protect.fold import fold_u32, fold_u64, fold_2s1_u32
from ..transform.four_step import FourStepPlan
from .inject import (
    inject_cle_matrix,
    inject_cle_vector,
    inject_kind,
    _mod_u64,
)

# ---------------------------------------------------------------------------
# 3-stage pipeline campaign (SCF / MCF taxonomy)
# ---------------------------------------------------------------------------

FAULT_TYPES = ("SCF-BF", "SCF-MBU", "MCF-PPE", "MCF-CTE", "MCF-CLE")


def _rand_mat(key, shape, hi):
    return jax.random.randint(key, shape, 0, hi, dtype=jnp.uint32)


def _three_stage_trial(key, ftype: str, S: int, P: int, W: int,
                       arith: ModArith, digit: DigitPlan):
    M = (1 << W) - 1
    bitwidth_p = P.bit_length()
    ks = jax.random.split(key, 12)
    A1 = _rand_mat(ks[0], (S, S), P)
    B1 = _rand_mat(ks[1], (S, S), P)
    C1 = matmul_mod(A1, B1, digit)
    X = fold_u32(C1.reshape(-1), W)                     # vec(C1) mod M
    T = _rand_mat(ks[2], (S * S,), M)
    hi, lo = mul32_parts(X, T)
    Y = fold_u64(hi, lo, W)                             # (X*T) mod M
    B2 = _mod_u64(jnp.zeros_like(Y), Y, P)[1].reshape(S, S)
    A2 = _rand_mat(ks[3], (S, S), P)
    C3 = matmul_mod(A2, B2, digit)

    inject_stage = jax.random.randint(ks[4], (), 1, 4)

    if ftype == "MCF-CLE":
        C1f = inject_cle_matrix(ks[5], A1, B1, C1, arith)
        Yf = inject_cle_vector(ks[6], X, T, Y, M)
        C3f = inject_cle_matrix(ks[7], A2, B2, C3, arith)
    else:
        C1f = inject_kind(ftype, ks[5], C1, P, bitwidth_p)
        Yf = inject_kind(ftype, ks[6], Y, M, W)
        C3f = inject_kind(ftype, ks[7], C3, P, bitwidth_p)

    C1s = jnp.where(inject_stage == 1, C1f, C1)
    Ys = jnp.where(inject_stage == 2, Yf, Y)
    C3s = jnp.where(inject_stage == 3, C3f, C3)

    det1 = ~matmul_check(A1, B1, C1s, arith)
    det2 = ~elementwise_fold_check(X, T, Ys, W)
    det3 = ~matmul_check(A2, B2, C3s, arith)
    det = jnp.stack([det1, det2, det3])
    return inject_stage, det[inject_stage - 1]


def three_stage_campaign(ftype: str, trials: int, S: int, P: int, W: int,
                         seed: int = 42) -> Dict[str, np.ndarray]:
    """Returns per-stage injected counts, undetected counts, and collision
    probabilities — the reference's monte_carlo outputs (:283-297)."""
    arith = ModArith.make(P)
    digit = DigitPlan.make(P, arith.qinv_neg)
    trial = partial(_three_stage_trial, ftype=ftype, S=S, P=P, W=W,
                    arith=arith, digit=digit)
    keys = jax.random.split(jax.random.PRNGKey(seed), trials)
    stages, detected = jax.jit(jax.vmap(lambda k: trial(k)))(keys)
    stages = np.asarray(stages)
    detected = np.asarray(detected)
    inj = np.array([(stages == s).sum() for s in (1, 2, 3)])
    und = np.array([((stages == s) & ~detected).sum() for s in (1, 2, 3)])
    with np.errstate(invalid="ignore"):
        p = np.where(inj > 0, und / np.maximum(inj, 1), 0.0)
    return {"injected": inj, "undetected": und, "collision_prob": p}


# ---------------------------------------------------------------------------
# Protected four-step NTT campaign (SBF / DBF / MOF1)
# ---------------------------------------------------------------------------

def _op_counts(n1: int, n2: int) -> Tuple[int, int, int]:
    """Butterfly-mult op counts per stage, matching relia_ntt_sim's op
    indexing (one op per butterfly multiply / twiddle multiply)."""
    s1 = n1 * (n2 // 2) * int(math.log2(n2))
    tw = n1 * n2
    s2 = n2 * (n1 // 2) * int(math.log2(n1))
    return s1, tw, s2


def _four_step_trial(key, kind: str, plan: FourStepPlan, fold_width: int,
                     target_stage: int | None = None):
    """One protected four-step NTT trial with the scenario's fault list
    injected into one stage (relia_ntt_sim.cpp:441-455: all faults of a
    scenario land in the SAME stage, at distinct targets).

    kind: a SCENARIO_KINDS name — single faults SBF/DBF/MLF (MOF1 alias) or
    multi-fault combos SBF+SBF, SBF+DBF, MLF+SBF, MLF+DBF, MLF+MLF.
    target_stage: 0/1/2 pins the stage (the reference's per-stage scenario
    rows); None samples it per trial weighted by butterfly-op counts
    (relia_ntt_sim.py behavior)."""
    from .inject import SCENARIO_KINDS, inject_elements
    kind_codes = SCENARIO_KINDS[kind]
    q = plan.q
    bw = q.bit_length()
    ks = jax.random.split(key, 8)
    a = jax.random.randint(ks[0], (plan.n,), 0, q, dtype=jnp.uint32)
    A = a.reshape(plan.n2, plan.n1)

    if target_stage is None:
        s1, tw, s2 = _op_counts(plan.n1, plan.n2)
        op = jax.random.randint(ks[1], (), 0, s1 + tw + s2)
        stage = jnp.where(op < s1, 0, jnp.where(op < s1 + tw, 1, 2))
    else:
        stage = jnp.int32(target_stage)

    B1 = matmul_mod(plan.W2, A, plan.digit)
    B1c = jnp.where(stage == 0, inject_elements(kind_codes, ks[2], B1, q, bw),
                    B1)

    B2_true = mul_mod_shoup(B1c, plan.T, plan.T_shoup, q)
    B2c = jnp.where(stage == 1,
                    inject_elements(kind_codes, ks[3], B2_true, q, bw),
                    B2_true)

    Y = matmul_mod(B2c, plan.W1T, plan.digit)
    Yc = jnp.where(stage == 2, inject_elements(kind_codes, ks[4], Y, q, bw),
                   Y)

    ok_b1 = stage1_projection_check(A, B1c, plan.W2, plan.digit, plan.arith, ks[5])
    # intra: collision model over the twiddle stage (relia_ntt_sim.py:164-171)
    intra = jnp.any(
        (fold_2s1_u32(B2c, fold_width) != fold_2s1_u32(B2_true, fold_width))
        & (B2c != B2_true))
    inter_ok = twiddle_inter_check(B1c, B2c, plan.T, plan.arith, ks[6])
    ok_b2 = stage2_projection_check(B2c, Yc, plan.W1T, plan.digit, plan.arith, ks[7])

    detected = (~ok_b1) | intra | (~inter_ok) | (~ok_b2)
    dets = jnp.stack([~ok_b1, intra, ~inter_ok, ~ok_b2])
    return stage, detected, dets


#: scenario table of the flagship simulator (relia_ntt_sim.cpp:401-405)
FOUR_STEP_SCENARIOS = ("SBF", "DBF", "MLF", "SBF+SBF", "SBF+DBF",
                       "MLF+SBF", "MLF+DBF", "MLF+MLF")


def four_step_ntt_campaign(kind: str, trials: int, n: int, q: int,
                           fold_width: int = 24, seed: int = 42,
                           plan: FourStepPlan | None = None,
                           target_stage: int | None = None) -> Dict[str, object]:
    """Detection/miss rates for the flagship protected four-step NTT
    (relia_ntt_sim.py:286-315; multi-fault scenario rows and per-detector
    attribution counters match relia_ntt_sim.cpp:456-466)."""
    if plan is None:
        plan = FourStepPlan.make(n, q)
    trial = partial(_four_step_trial, kind=kind, plan=plan,
                    fold_width=fold_width, target_stage=target_stage)
    keys = jax.random.split(jax.random.PRNGKey(seed), trials)
    stages, detected, dets = jax.jit(jax.vmap(lambda k: trial(k)))(keys)
    stages = np.asarray(stages)
    detected = np.asarray(detected)
    dets = np.asarray(dets)                      # (trials, 4): b1/intra/inter/b2
    det_rate = detected.mean()
    stats = {
        # reference counters: each detector that fired among detected trials
        "batch1_catch": int((detected & dets[:, 0]).sum()),
        "intra_catch": int((detected & dets[:, 1]).sum()),
        "inter_catch": int((detected & dets[:, 2]).sum()),
        "batch2_catch": int((detected & dets[:, 3]).sum()),
        # legacy priority attribution (intra > inter > batch)
        "batch_catch": int((detected & ~dets[:, 1] & ~dets[:, 2]).sum()),
    }
    per_stage_miss = np.array([
        (~detected)[stages == s].mean() if (stages == s).any() else 0.0
        for s in (0, 1, 2)
    ])
    return {
        "det_rate": float(det_rate),
        "miss_rate": float(1.0 - det_rate),
        "stats": stats,
        "per_stage_miss": per_stage_miss,
    }


def four_step_scenario_table(trials: int, n: int, q: int,
                             fold_width: int = 24, seed: int = 42) -> list:
    """The reference's full scenario × stage table
    (reliaNTT_test_result.txt rows): one row per (scenario, target stage)."""
    plan = FourStepPlan.make(n, q)
    rows = []
    for sc in FOUR_STEP_SCENARIOS:
        for stage in (0, 1, 2):
            res = four_step_ntt_campaign(sc, trials, n, q, fold_width,
                                         seed, plan, target_stage=stage)
            rows.append({
                "scenario": sc, "stage": stage,
                "det_rate": res["det_rate"], "miss_rate": res["miss_rate"],
                **res["stats"],
            })
    return rows
