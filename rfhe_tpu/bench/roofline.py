"""NTT roofline accounting: measured butterflies/s and MAC/s vs the
device's published peaks (plays the role of the reference's batched
radix-8 device-NTT throughput measurement, reliability_test/ntt_test.cu:95
driven by run_bench_test.sh).

Peaks come from bench/device.PEAKS, keyed by device_kind; a device not in
that table is an error.

Work accounting per negacyclic transform of size n (one limb):
  radix-2 butterfly count  : (n/2)·log2(n)  (the classic NTT work metric)
  int8 matmul MACs         : n·(n1·nd_x·nd_w + n2·nd_x·nd_w)  (four-step)
  HBM floor bytes          : 2·4·n           (read coeffs + write slots)

Usage: python -m rfhe_tpu.bench.roofline [--n 4096] [--limbs 21]
           [--batch 8] [--csv results/roofline.csv]
"""
from __future__ import annotations

import argparse
import csv
import math
import sys

import numpy as np

from . import device


def measure(n: int, limbs: int, batch: int, peaks: dict, qbits: int = 30):
    import jax
    import jax.numpy as jnp
    from .. import numth
    from ..ops import ntt_pease
    from ..ops.ntt_mxu import MxuNttPlan
    from .devtime import device_time

    primes = numth.find_ntt_primes(n, qbits, limbs)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, min(primes), (batch, limbs, n),
                                 dtype=np.uint32))
    tr = batch * limbs
    rows = []

    mp = MxuNttPlan.make(n, primes)
    timings = [("mxu_fwd", device_time(mp.fwd, x)),
               ("mxu_inv", device_time(mp.inv, x))]
    pp = ntt_pease.PeaseNttPlan.make(n, primes)
    timings.append(("pease_fwd",
                    device_time(lambda a: ntt_pease.negacyclic_ntt(a, pp), x)))

    bfly = (n // 2) * (n.bit_length() - 1)
    # per-stage MACs: stage 1 contracts n2 with s1's digit counts, stage 2
    # contracts n1 with s2's (they choose digit widths independently)
    macs = n * (mp.n2 * mp.s1.nd_x * mp.s1.nd_w
                + mp.n1 * mp.s2.nd_x * mp.s2.nd_w)
    hbm = 2 * 4 * n

    for name, t in timings:
        tps = tr / t if t > 0 else float("inf")
        row = {
            "impl": name, "n": n, "limbs": limbs, "batch": batch,
            "device_us_per_call": round(t * 1e6, 2),
            "transforms_per_s": round(tps, 1),
            "butterflies_per_s": f"{tps * bfly:.3e}",
            "hbm_floor_pct": round(
                100 * tps * hbm / peaks["hbm_bytes_per_s"], 2),
        }
        if name.startswith("mxu"):
            ops = 2 * tps * macs           # MAC = mul+add
            row["int8_ops_per_s"] = f"{ops:.3e}"
            row["int8_peak_pct"] = round(
                100 * ops / peaks["int8_ops_per_s"], 2)
        rows.append(row)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--limbs", type=int, default=21)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--qbits", type=int, default=30,
                    help="prime width; narrower primes need fewer int8 "
                         "digit groups")
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    device.require_gpu()
    print(device.banner())
    rows = measure(args.n, args.limbs, args.batch,
                   device.peaks(device.device_info()["kind"]), qbits=args.qbits)
    cols = ["impl", "n", "limbs", "batch", "device_us_per_call",
            "transforms_per_s", "butterflies_per_s", "hbm_floor_pct",
            "int8_ops_per_s", "int8_peak_pct"]
    w = csv.DictWriter(sys.stdout, fieldnames=cols)
    w.writeheader()
    for r in rows:
        w.writerow(r)
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            wf = csv.DictWriter(f, fieldnames=cols)
            wf.writeheader()
            for r in rows:
                wf.writerow(r)


if __name__ == "__main__":
    main()
