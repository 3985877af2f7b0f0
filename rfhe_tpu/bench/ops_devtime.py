"""Per-op DEVICE-TIME table for the headline CKKS config (VERDICT r1 #9:
"measure, don't dispatch").

Shape-preserving ops (rotate, conjugate, add, dyadic product, NTT/INTT) are
measured with the slope method (bench/devtime.py), which cancels the
per-call dispatch cost exactly.  Ops that change the ciphertext
structure (mult+relin+rescale drops limbs; encrypt/decrypt cross the host
boundary) are wall-clock amortized over a 50-deep pipelined dispatch queue
and marked mode=wall — their numbers still contain residual dispatch cost
and are upper bounds.

Usage: python -m rfhe_tpu.bench.ops_devtime [--n 4096] [--levels 20]
           [--csv results/ops_devtime.csv]
"""
from __future__ import annotations

import argparse
import csv
import sys
import time

import numpy as np


def measure(n: int, levels: int):
    import jax
    from ..fhe import CkksContext, CkksParams
    from ..ops import ntt_pease
    from .devtime import device_time

    params = CkksParams.make(n=n, levels=levels, q0_bits=30, scale_bits=28)
    ckks = CkksContext(params, seed=7)
    rng = np.random.default_rng(0)
    z = rng.uniform(-1, 1, n // 2) + 0j
    pt, scale = ckks.encode(z)
    ct = ckks.encrypt(pt, scale)
    ct2 = ckks.encrypt(pt, scale)
    rows = []

    def dev(name, body, x):
        # adaptive reps as in bench/phase_profile: a 0.0 slope means the
        # op's signal fell below host noise — escalate 4x (twice) until
        # the measurement resolves (sub-us ops like `add` need ~2k reps)
        r1, r2 = 16, 128
        for _ in range(3):
            t = device_time(body, x, r1=r1, r2=r2)
            if t > 0.0:
                break
            r1, r2 = r1 * 4, r2 * 4
        rows.append({"op": name, "mode": "device", "us": round(t * 1e6, 2)})

    def wall(name, fn, sync, iters=50):
        out = fn()
        sync(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        sync(out)
        us = (time.perf_counter() - t0) / iters * 1e6
        rows.append({"op": name, "mode": "wall", "us": round(us, 2)})

    x = ct.c[0].data
    # slice the special prime(s) off: the ciphertext carries only the
    # active limbs, the ctx plan carries active + special
    plan = ckks.ctx.plan.slice(x.shape[0])

    dev("ntt_fwd", lambda a: ntt_pease.negacyclic_ntt(a, plan), x)
    dev("ntt_inv", lambda a: ntt_pease.negacyclic_intt(a, plan), x)
    from ..ops import u32
    dev("dyadic_mult",
        lambda a: u32.mont_mul(a, a, plan.qb(1), plan.qinvb(1)), x)
    ckks.rotate(ct, 1); ckks.conjugate(ct)   # build galois keys OUTSIDE
    #                                          the timed traces (lazy key
    #                                          gen inside a trace leaks)
    dev("rotate", lambda c: ckks.rotate(c, 1), ct)
    dev("conjugate", lambda c: ckks.conjugate(c), ct)
    dev("add", lambda c: ckks.add(c, c), ct)

    sync_ct = lambda o: jax.block_until_ready(o.c[0].data)
    wall("mult_relin", lambda: ckks.multiply_relin(ct, ct2), sync_ct)
    prod = ckks.multiply_relin(ct, ct2)
    wall("rescale", lambda: ckks.rescale(prod), sync_ct)
    wall("encrypt", lambda: ckks.encrypt(pt, scale), sync_ct)
    wall("decrypt", lambda: ckks.decrypt(ct),
         lambda o: jax.block_until_ready(o.data), iters=20)
    t0 = time.perf_counter()
    for _ in range(5):
        ckks.decrypt_decode(ct)
    rows.append({"op": "decrypt_decode(host)", "mode": "wall",
                 "us": round((time.perf_counter() - t0) / 5 * 1e6, 2)})

    # BGV / BFV slope-method rows (round-4 verdict weak #7: the scheme
    # suite's device story was wall-only).  rotate_rows and multiply_relin
    # are shape-preserving in both schemes (no rescale; BEHZ multiply
    # returns to the input basis), so they ride the same fori_loop slope.
    from ..fhe.bgv import BgvContext
    from ..fhe.bfv import BfvContext
    from ..fhe.params import BgvParams, BfvParams

    bgv = BgvContext(BgvParams.make(n=n, levels=min(levels, 9), q_bits=30,
                                    t_bits=16), seed=11)
    mb = rng.integers(0, bgv.t, (2, n // 2), dtype=np.uint32)
    ctb = bgv.encrypt(bgv.encode(mb))
    bgv.rotate_rows(ctb, 1); bgv.multiply_relin(ctb, ctb)   # warm keys
    dev("bgv_rotate_rows", lambda c: bgv.rotate_rows(c, 1), ctb)
    dev("bgv_multiply_relin", lambda c: bgv.multiply_relin(c, c), ctb)

    bfv = BfvContext(BfvParams.make(n=n, levels=min(levels, 9), q_bits=30,
                                    t_bits=16), seed=13)
    mf = rng.integers(0, bfv.t, (2, n // 2), dtype=np.uint32)
    ctf = bfv.encrypt(bfv.encode(mf))
    bfv.rotate_rows(ctf, 1); bfv.multiply_relin(ctf, ctf)   # warm keys
    dev("bfv_rotate_rows", lambda c: bfv.rotate_rows(c, 1), ctf)
    dev("bfv_multiply_relin", lambda c: bfv.multiply_relin(c, c), ctf)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--levels", type=int, default=20)
    ap.add_argument("--csv", default="results/ops_devtime.csv")
    args = ap.parse_args(argv)
    from . import device
    device.require_gpu()
    print(device.banner())
    rows = measure(args.n, args.levels)
    cols = ["op", "mode", "us"]
    w = csv.DictWriter(sys.stdout, fieldnames=cols)
    w.writeheader()
    [w.writerow(r) for r in rows]
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            wf = csv.DictWriter(f, fieldnames=cols)
            wf.writeheader()
            [wf.writerow(r) for r in rows]


if __name__ == "__main__":
    main()
