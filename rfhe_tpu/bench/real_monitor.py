"""Long-running silent-fault monitor (run_real_test.sh analog).

The reference stresses an overclocked GPU with 8 shell-parallel processes x
1000 runs of a clean NTT executed twice and diffed, logging clocks before
each run (reliability_test/run_real_test.sh:1-36, ntt_real_test.cu) — any
nonzero Hamming distance is a genuine silent hardware fault.  nvidia-smi
on the measurement machine can set no clocks, so this is the monitoring
half only: run the production
batched NTT (and a zero-injection encrypted dot product every `--dot-every`
iterations) clean-vs-clean for --runs iterations and log one line per run.

Any line with hamming != 0 is a silent-fault capture (the reference's
errorset.txt analog).

Usage: python -m rfhe_tpu.bench.real_monitor [--runs 1000] [--log-dim 12]
           [--batch 8] [--out results/real_monitor_log.txt]
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> None:
    from ..utils.compilecache import enable_compilation_cache
    enable_compilation_cache()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=1000)
    ap.add_argument("--log-dim", type=int, default=12)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dot-every", type=int, default=100,
                    help="also run a zero-injection encrypted dotprod "
                         "(dotprod_real_test.cu analog) every K runs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/real_monitor_log.txt")
    args = ap.parse_args(argv)
    from . import device
    device.require_gpu()
    print(device.banner())

    import jax
    import numpy as np

    from .. import numth
    from ..faults.hardware import dotprod_fault_campaign, ntt_real_test
    from ..fhe.bgv import BgvContext
    from ..fhe.params import BgvParams
    from ..ops.ntt import StackedNttPlan

    n = 1 << args.log_dim
    primes = numth.find_ntt_primes(n, 30, args.batch)
    plan = StackedNttPlan.make(n, primes)
    bgv = BgvContext(BgvParams.make(n=1024, levels=2, q_bits=30, t_bits=16),
                     seed=11)
    dev = jax.devices()[0]
    faults = 0
    t_start = time.time()
    with open(args.out, "w") as f:
        f.write(f"# real-fault monitor: device={dev.device_kind} "
                f"n={n} batch={args.batch} runs={args.runs} "
                f"started={time.strftime('%Y-%m-%d %H:%M:%S')}\n")
        f.write("# run\tkind\thamming_bits\tsymbol_errors\telapsed_s\n")
        for r in range(args.runs):
            stats = ntt_real_test(plan, batch=args.batch, seed=args.seed + r)
            faults += stats.hamming_bits != 0
            f.write(f"{r}\tntt\t{stats.hamming_bits}\t"
                    f"{stats.symbol_errors}\t{time.time() - t_start:.1f}\n")
            if stats.hamming_bits:
                f.write(f"# [FAULT DETECTED] run {r}: hamming="
                        f"{stats.hamming_bits}\n")
                print(f"[FAULT DETECTED] run {r}", file=sys.stderr)
            if args.dot_every and r % args.dot_every == 0:
                res = dotprod_fault_campaign(bgv, 0, 0, seed=args.seed + r)
                ok = (res["symbol_errors"] == 0 and res["dot_hamming"] == 0)
                faults += not ok
                f.write(f"{r}\tdotprod\t{res['dot_hamming']}\t"
                        f"{res['symbol_errors']}\t"
                        f"{time.time() - t_start:.1f}\n")
            if r % 100 == 0:
                f.flush()
                print(f"run {r}/{args.runs}: faults so far {faults}",
                      file=sys.stderr, flush=True)
        f.write(f"# finished: {args.runs} runs, {faults} silent faults, "
                f"{time.time() - t_start:.1f}s\n")
    print(f"wrote {args.out}: {args.runs} runs, {faults} silent faults")


if __name__ == "__main__":
    main()
