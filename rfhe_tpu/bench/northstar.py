"""North-star shape measurements on the GPU.

Row 1: CKKS multiply+rescale, N = 2^16, L = 16 (17 limbs + special) —
       the BASELINE.json "bit-exact CKKS mult+rescale at N=2^16" target.
Row 2: BGV encrypted dot product, N = 16384, ~300-bit chain, 20-bit t —
       the reference's real-GPU campaign config
       (reliability_test/dotprod_test.cu:198-204; 6 x 50-bit limbs there,
       10 x 30-bit here — same modulus budget, u32-native limb width).

Writes results/northstar.csv and prints the rows.  Compile time is
reported as setup_compile_s; warm latencies are wall-clock amortized.

Usage: python -m rfhe_tpu.bench.northstar [--csv results/northstar.csv]
"""
from __future__ import annotations

import argparse
import csv
import sys
import time

import numpy as np


def _warm_ms(fn, ready, iters=10):
    out = fn()
    ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


def ckks_row():
    import jax
    from ..fhe import CkksContext, CkksParams

    n, levels = 65536, 16
    t0 = time.time()
    # composite scale 2^56 (two u32 limbs per level): the precision
    # regime of the reference substrates' 50-60-bit limbs
    params = CkksParams.make(n=n, levels=levels, q0_bits=31, scale_bits=56)
    ckks = CkksContext(params, seed=7)
    rng = np.random.default_rng(0)
    z = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
    ct = ckks.encrypt(*ckks.encode(z))
    m = ckks.rescale(ckks.multiply(ct, ct))
    jax.block_until_ready(m.c[0].data)
    compile_s = time.time() - t0
    err = float(np.max(np.abs(ckks.decrypt_decode(m) - z * z)))
    ms = _warm_ms(lambda: ckks.rescale(ckks.multiply(ct, ct)),
                  lambda o: jax.block_until_ready(o.c[0].data))
    return {
        "workload": "ckks_mult_rescale", "n": n, "limbs": len(params.moduli),
        "warm_ms": round(ms, 2), "max_err": f"{err:.2e}",
        "setup_compile_s": round(compile_s, 1), "exact": err < 1e-6,
    }


def bgv_row():
    import jax
    from ..fhe import BgvContext, BgvParams
    from ..models.dotprod import dot_product_bgv

    n = 16384
    t0 = time.time()
    params = BgvParams.make(n=n, levels=9, q_bits=30, t_bits=20)
    bgv = BgvContext(params, seed=11)
    rng = np.random.default_rng(1)
    m1 = rng.integers(0, bgv.t, (2, n // 2), dtype=np.uint32)
    m2 = rng.integers(0, bgv.t, (2, n // 2), dtype=np.uint32)
    ct_x = bgv.encrypt(bgv.encode(m1))
    ct_y = bgv.encrypt(bgv.encode(m2))
    out = dot_product_bgv(bgv, ct_x, ct_y)
    jax.block_until_ready(out.c[0].data)
    compile_s = time.time() - t0
    got = bgv.decrypt_decode(out)
    expect = int((m1.astype(object) * m2.astype(object)).sum()) % bgv.t
    exact = bool((got == expect).all())
    ms = _warm_ms(lambda: dot_product_bgv(bgv, ct_x, ct_y),
                  lambda o: jax.block_until_ready(o.c[0].data), iters=5)
    return {
        "workload": "bgv_dotprod", "n": n, "limbs": len(params.moduli),
        "warm_ms": round(ms, 2), "max_err": "0" if exact else "MISMATCH",
        "setup_compile_s": round(compile_s, 1), "exact": exact,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv", default="results/northstar.csv")
    ap.add_argument("--only", choices=["ckks", "bgv"], default=None)
    args = ap.parse_args(argv)
    from . import device
    device.require_gpu()
    print(device.banner())
    rows = []
    if args.only in (None, "ckks"):
        rows.append(ckks_row())
    if args.only in (None, "bgv"):
        rows.append(bgv_row())
    cols = ["workload", "n", "limbs", "warm_ms", "max_err",
            "setup_compile_s", "exact"]
    w = csv.DictWriter(sys.stdout, fieldnames=cols)
    w.writeheader()
    [w.writerow(r) for r in rows]
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            wf = csv.DictWriter(f, fieldnames=cols)
            wf.writeheader()
            [wf.writerow(r) for r in rows]
    if not all(r["exact"] for r in rows):
        raise SystemExit("north-star correctness FAILED")


if __name__ == "__main__":
    main()
