"""ctypes bindings for the native Monte-Carlo engine (native/rfhe_mc.cpp).

The library is built from source on first use (g++ -O3 -fopenmp -shared;
the binary is git-ignored, never committed); host-side exact
op-granularity campaigns complement the vectorized on-device JAX campaigns
the way the reference's OpenMP twins complement its Python simulators.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path
from typing import Dict

_SRC = Path(__file__).resolve().parent.parent / "native" / "rfhe_mc.cpp"
_LIB = Path(__file__).resolve().parent.parent / "native" / "librfhe_mc.so"

FAULT_IDS = {"SCF-BF": 0, "SCF-MBU": 1, "MCF-PPE": 2, "MCF-CTE": 3,
             "MCF-CLE": 4}
KIND_IDS = {"SBF": 0, "DBF": 1, "MOF1": 2, "MLF": 2}

#: scenario name -> native kind-code list (relia_ntt_sim.cpp:401-405)
SCENARIOS = {
    "SBF": [0], "DBF": [1], "MLF": [2], "MOF1": [2],
    "SBF+SBF": [0, 0], "SBF+DBF": [0, 1],
    "MLF+SBF": [2, 0], "MLF+DBF": [2, 1], "MLF+MLF": [2, 2],
}


def build(force: bool = False) -> Path:
    """Compile the library from source if it is missing or older than the
    source.  The build writes a private temporary file next to the target
    and renames it into place, so processes that build at the same moment
    never load a half-written library."""
    if _LIB.exists() and not force and \
            _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    fd, tmp = tempfile.mkstemp(prefix=_LIB.name + ".tmp", dir=_LIB.parent)
    os.close(fd)
    try:
        cmd = ["g++", "-O3", "-fopenmp", "-std=c++17", "-shared", "-fPIC",
               str(_SRC), "-o", tmp]
        subprocess.run(cmd, check=True)
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _LIB


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.four_step_mc_multi.argtypes = [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_longlong)]
    lib.three_stage_mc.argtypes = [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, ctypes.POINTER(ctypes.c_longlong)]
    lib.montgomery_mc.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_longlong)]
    lib.barrett_final_mc.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_longlong)]
    return lib


def four_step_mc(kind: str, trials: int, n: int, q: int,
                 fold_width: int = 24, seed: int = 42,
                 target_stage: int | None = None) -> Dict:
    """Protected four-step NTT MC at butterfly-op granularity
    (relia_ntt_sim semantics; native OpenMP).

    kind: a SCENARIOS name — single faults (SBF/DBF/MLF) or the reference's
    multi-fault combos (SBF+SBF … MLF+MLF), all faults at distinct ops.
    target_stage: None = anywhere in the transform; 0/1/2 pins the stage's
    op range (the reference's per-stage scenario rows)."""
    from .numth import primitive_root
    g = primitive_root(q)
    codes = SCENARIOS[kind]
    arr = (ctypes.c_int * len(codes))(*codes)
    out = (ctypes.c_longlong * 6)()
    _lib().four_step_mc_multi(
        trials, n, q, g, fold_width, arr, len(codes),
        -1 if target_stage is None else target_stage, seed, out)
    detected = out[0]
    return {
        "det_rate": detected / trials,
        "miss_rate": 1.0 - detected / trials,
        "stats": {"batch1_catch": out[1], "intra_catch": out[2],
                  "inter_catch": out[3], "batch2_catch": out[4],
                  "batch_catch": out[1] + out[4]},
    }


def four_step_scenario_table(trials: int, n: int, q: int,
                             fold_width: int = 24, seed: int = 42) -> list:
    """Full scenario × stage table (reliaNTT_test_result.txt layout)."""
    rows = []
    for sc in ("SBF", "DBF", "MLF", "SBF+SBF", "SBF+DBF",
               "MLF+SBF", "MLF+DBF", "MLF+MLF"):
        for stage in (0, 1, 2):
            res = four_step_mc(sc, trials, n, q, fold_width, seed,
                               target_stage=stage)
            rows.append({"scenario": sc, "stage": stage,
                         "det_rate": res["det_rate"],
                         "miss_rate": res["miss_rate"], **res["stats"]})
    return rows


def three_stage_mc(ftype: str, trials: int, S: int, P: int, W: int,
                   seed: int = 42) -> Dict:
    """3-stage pipeline MC (four_step_ntt_protected semantics; native)."""
    out = (ctypes.c_longlong * 6)()
    _lib().three_stage_mc(trials, S, P, W, FAULT_IDS[ftype], seed, out)
    inj = [out[i] for i in range(3)]
    und = [out[3 + i] for i in range(3)]
    return {
        "injected": inj,
        "undetected": und,
        "collision_prob": [u / i if i else 0.0 for u, i in zip(und, inj)],
    }


def montgomery_mc(fold_width: int, scheme, trials: int, pbits: int = 37,
                  vec_len: int = 8192, flip_count: int = 2,
                  seed: int = 42) -> Dict:
    """Native montgomery_campaign (reduction_campaigns.py:178-259 semantics)
    at archive trial counts (montgomery.py:148-190 role)."""
    use_m, use_mp, use_final = (list(scheme) + [False, False])[:3]
    out = (ctypes.c_longlong * 2)()
    _lib().montgomery_mc(trials, pbits, vec_len, fold_width, int(use_m),
                         int(use_mp), int(use_final), flip_count, seed, out)
    TP, FN = out[0], out[1]
    rate = TP / (TP + FN) if TP + FN else 1.0
    return {"detection_rate": rate, "TP": TP, "FN": FN}


def barrett_final_mc(s_bits: int, fault_model: int, trials: int,
                     pbits: int = 37, vec_len: int = 8192,
                     use_intra: bool = True, use_range: bool = True,
                     use_sum: bool = True, seed: int = 1) -> Dict:
    """Native barrett_final_campaign (Intra/Range/Sum x 4 fault models;
    barrett_final.py:118-167 role) at the reference's 10k-trial scale."""
    out = (ctypes.c_longlong * 4)()
    _lib().barrett_final_mc(trials, pbits, s_bits, fault_model,
                            int(use_intra), int(use_range), int(use_sum),
                            vec_len, seed, out)
    und, intra_only, inter_only, both = out[0], out[1], out[2], out[3]
    return {
        "miss_rate": und / trials if trials else 0.0,
        "det_intra_only": intra_only,
        "det_sum_only": inter_only,
        "det_both": both,
        "undetected": und,
    }
