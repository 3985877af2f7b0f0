"""Measured per-atom protection overheads (draw_atom_opt_cost.py analog).

The reference's headline overhead model (NTT ×1.009–1.033, BaseConv ×~1.000,
ModMul ×1.1406, Others ×2) is a cost model; here we MEASURE the same ratios
on our kernels: protected vs unprotected execution time of each atom on the
current backend.

Usage: python -m rfhe_tpu.bench.overheads [--n N] [--out results]
Writes results/atom_overheads.csv consumed by figures.draw end_to_end.
"""
from __future__ import annotations

import argparse
import csv
import time
from pathlib import Path

import numpy as np


def _bench(fn, args, iters=20) -> float:
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def measure(n: int = 4096, batch: int = 8, fold_width: int = 24,
            iters: int = 20) -> dict:
    import jax
    import jax.numpy as jnp
    from .. import numth
    from ..transform.four_step import (
        FourStepPlan, four_step_ntt, four_step_ntt_stages)
    from ..protect.checks import (
        stage1_projection_check, stage2_projection_check, twiddle_inter_check)
    from ..ops import u32
    from ..ops.baseconv import BaseConvPlan, base_conv
    from ..protect.checks import baseconv_append_checksum, baseconv_ecc_check
    from ..protect.fold import fold_2s1_u32, fold_2s1_u64

    q = numth.find_ntt_prime(n, 30)
    plan = FourStepPlan.make(n, q)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, q, (batch, n), dtype=np.uint32))

    # --- NTT: plain four-step vs protected (3 projections + intra fold) ---
    plain = jax.jit(lambda v: four_step_ntt(v, plan))

    def protected(v, key):
        k1, k2, k3 = jax.random.split(key, 3)
        A, B1, B2, Y = four_step_ntt_stages(v, plan)
        ok1 = stage1_projection_check(A, B1, plan.W2, plan.digit, plan.arith, k1)
        ok2 = twiddle_inter_check(B1, B2, plan.T, plan.arith, k2)
        ok3 = stage2_projection_check(B2, Y, plan.W1T, plan.digit, plan.arith, k3)
        y = jnp.swapaxes(Y, -1, -2).reshape(v.shape)
        return y, ok1 & ok2 & ok3

    prot = jax.jit(protected)
    t_plain = _bench(plain, (x,), iters)
    t_prot = _bench(prot, (x, jax.random.PRNGKey(0)), iters)
    ntt_ovh = t_prot / t_plain

    # --- ModMul: dyadic product vs + intra fold product check ------------
    _, qinv, r2 = numth.montgomery_constants(q, 32)
    a = jnp.asarray(rng.integers(0, q, (batch, n), dtype=np.uint32))
    b = jnp.asarray(rng.integers(0, q, (batch, n), dtype=np.uint32))
    mm_plain = jax.jit(lambda u, v: u32.mont_mul(u, v, q, qinv))

    def mm_prot(u, v):
        hi, lo = u32.mul32_parts(u, v)
        out = u32.mont_mul(u, v, q, qinv)
        fa = fold_2s1_u32(u, 8)
        fb = fold_2s1_u32(v, 8)
        ph, plo = u32.mul32_parts(fa, fb)
        ok = fold_2s1_u64(ph, plo, 8) == fold_2s1_u64(hi, lo, 8)
        return out, ok

    t_mm = _bench(mm_plain, (a, b), iters)
    t_mmp = _bench(jax.jit(mm_prot), (a, b), iters)
    modmul_ovh = t_mmp / t_mm

    # --- BaseConv: plain vs appended-checksum row ------------------------
    import random as _r
    moduli_in = numth.generate_crt_primes(8, 28, _r.Random(1))
    moduli_out = [moduli_in[0] * 1]  # single grouped output for timing
    moduli_out = numth.generate_crt_primes(4, 30, _r.Random(2))
    bplan = BaseConvPlan.make(moduli_in, moduli_out)
    res = jnp.asarray(np.stack(
        [rng.integers(0, p, n, dtype=np.uint32) for p in moduli_in]))
    bc_plain = jax.jit(lambda r_: base_conv(r_, bplan))

    def bc_prot(r_):
        with_ecc = baseconv_append_checksum(r_, list(moduli_in))
        out = base_conv(with_ecc, bplan)
        return out[..., :-1], baseconv_ecc_check(out, list(moduli_out))

    t_bc = _bench(bc_plain, (res,), iters)
    t_bcp = _bench(jax.jit(bc_prot), (res,), iters)
    baseconv_ovh = t_bcp / t_bc

    return {
        "NTTCost": ntt_ovh,
        "BaseConvCost": baseconv_ovh,
        "ModmulCost": modmul_ovh,
        "Others": 2.0,       # duplicated execution, by construction
        "n": n,
        "t_ntt_plain_us": t_plain * 1e6,
        "t_ntt_prot_us": t_prot * 1e6,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", type=str, default="results")
    args = ap.parse_args(argv)
    from . import device
    device.require_gpu()
    print(device.banner())
    res = measure(args.n, args.batch, iters=args.iters)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    path = f"{args.out}/atom_overheads.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["atom", "overhead"])
        for k in ("NTTCost", "BaseConvCost", "ModmulCost", "Others"):
            w.writerow([k, f"{res[k]:.4f}"])
    for k in ("NTTCost", "BaseConvCost", "ModmulCost", "Others"):
        print(f"{k}: x{res[k]:.4f}")
    print("wrote", path)


if __name__ == "__main__":
    main()
