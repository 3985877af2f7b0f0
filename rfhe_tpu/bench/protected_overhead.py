"""Protection overhead measured ON THE PRODUCTION PATH (VERDICT round-2
item #2): protected-vs-plain device time of the kernels the scheme layer
actually runs — the int8-matmul NTT with the NttGuard projection, the checked
dyadic Montgomery MAC, and the full protected rotation / multiply+relin
(fhe/protected.py) against the plain evaluator.

Every pair is timed with the slope method (bench/devtime) on identical
shapes; checked variants fold their ok-flags into the returned array with a
wrapping add so the comparison logic stays live inside the fori_loop.

Usage: python -m rfhe_tpu.bench.protected_overhead [--n 4096] [--levels 9]
           [--csv results/protected_overheads.csv]
Reference comparison: the overhead MODEL in
profile_framewk/draw_scripts/draw_atom_opt_cost.py:11-15 (NTT x1.009-1.033,
ModMul x1.1406, Others x2) — modeled there, measured here.
"""
from __future__ import annotations

import argparse
import csv
import sys


def measure(n: int, levels: int, batch: int = 8):
    import jax.numpy as jnp
    import numpy as np
    from .. import numth
    from ..fhe.ckks import Ciphertext, CkksContext
    from ..fhe.params import CkksParams
    from ..fhe.protected import ProtectedCkks, all_ok
    from ..fhe.rns import RnsPoly
    from ..ops import u32
    from ..ops.ntt_mxu import MxuNttPlan
    from ..protect.checks import mont_mul_checked
    from ..protect.ntt_guard import NttGuard
    from .devtime import device_time as _dt

    def device_time(fn, v, r1=8, r2=64):
        # floor the slope at 50 ns so a noisy zero-slope never divides by 0
        return max(_dt(fn, v, r1=r1, r2=r2, iters=10), 5e-8)

    rows = []
    rng = np.random.default_rng(0)

    # --- NTT: production transform vs transform + NttGuard projection ----
    primes = numth.find_ntt_primes(n, 30, max(2 * levels + 1, 3))
    plan = MxuNttPlan.make(n, primes)
    guard = NttGuard.make(plan)
    x = jnp.asarray(rng.integers(0, min(primes), (batch, plan.L, n),
                                 dtype=np.uint32))

    def ntt_plain(v):
        return plan.fwd(v)

    def ntt_prot(v):
        y = plan.fwd(v)
        ok = guard.check_fwd(v, y)
        return y + ok[..., None].astype(jnp.uint32)

    # atom bodies are small: at small rep counts the chained-dispatch host
    # floor can exceed body^r device time and the slope collapses to 0 —
    # reps must push the r2 program well past the floor
    t_p = device_time(ntt_plain, x, r1=128, r2=1024)
    t_g = device_time(ntt_prot, x, r1=128, r2=1024)
    rows.append({"atom": "NTT(guarded)", "plain_us": t_p * 1e6,
                 "prot_us": t_g * 1e6, "overhead": t_g / t_p})

    # --- ModMul: dyadic mont_mul vs mont_mul_checked ---------------------
    qb = plan.q_arr[:, None]
    qinvb = plan.qinv_arr[:, None]
    w = jnp.asarray(rng.integers(0, min(primes), (plan.L, n),
                                 dtype=np.uint32))

    def mm_plain(v):
        return u32.mont_mul(v, w, qb, qinvb)

    def mm_prot(v):
        out, ok = mont_mul_checked(v, w, qb, qinvb)
        return out + ok.astype(jnp.uint32)

    t_p = device_time(mm_plain, x, r1=128, r2=2048)
    t_g = device_time(mm_prot, x, r1=128, r2=2048)
    rows.append({"atom": "ModMul(fold)", "plain_us": t_p * 1e6,
                 "prot_us": t_g * 1e6, "overhead": t_g / t_p})

    # --- full evaluator ops: plain vs protected --------------------------
    ckks = CkksContext(CkksParams.make(n=n, levels=levels))
    prot = ProtectedCkks(ckks)
    lvl = ckks.L - 1
    g = ckks.rotation_galois_element(1)
    ksk = ckks.galois_key(g)
    rlk = ckks.rlk
    c01 = jnp.asarray(np.stack([np.stack([
        rng.integers(0, int(ckks.ctx.moduli[i]), n, dtype=np.uint32)
        for i in range(lvl + 1)]) for _ in range(2)]))

    def mk(c):
        return Ciphertext([RnsPoly(c[0], True), RnsPoly(c[1], True)], 1.0)

    ks_probe = prot._ks_probe(ksk, lvl, salt=g)       # built outside traces
    perm_probe = prot._perm_probe(g, lvl + 1)

    def rot_plain(c):
        out = ckks._apply_galois_impl(mk(c), ksk, g)
        return jnp.stack([out.c[0].data, out.c[1].data])

    def rot_prot(c):
        out, flags = prot._galois_impl(mk(c), ksk, g, lvl, None,
                                       ks_probe, perm_probe)
        o = all_ok(flags).astype(jnp.uint32)
        return jnp.stack([out.c[0].data + o, out.c[1].data])

    t_p = device_time(rot_plain, c01, r1=8, r2=64)
    t_g = device_time(rot_prot, c01, r1=8, r2=64)
    rows.append({"atom": "Rotation(e2e)", "plain_us": t_p * 1e6,
                 "prot_us": t_g * 1e6, "overhead": t_g / t_p})

    def mul_plain(c):
        ct = mk(c)
        out = ckks._relinearize_impl(ckks._multiply_impl(ct, ct), rlk)
        return jnp.stack([out.c[0].data, out.c[1].data])

    rlk_probe = prot._ks_probe(rlk, lvl, salt=-1)

    def mul_prot(c):
        out, flags = prot._mul_relin_impl(
            [c[0], c[1]], [c[0], c[1]], rlk.b, rlk.a, rlk_probe, lvl,
            1.0, 1, None)
        o = all_ok(flags).astype(jnp.uint32)
        return jnp.stack([out.c[0].data + o, out.c[1].data])

    t_p = device_time(mul_plain, c01, r1=8, r2=64)
    t_g = device_time(mul_prot, c01, r1=8, r2=64)
    rows.append({"atom": "HMul+Relin(e2e)", "plain_us": t_p * 1e6,
                 "prot_us": t_g * 1e6, "overhead": t_g / t_p})
    return rows


def main(argv=None) -> None:
    from ..utils.compilecache import enable_compilation_cache
    enable_compilation_cache()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--levels", type=int, default=9)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    from . import device
    device.require_gpu()
    print(device.banner())
    rows = measure(args.n, args.levels, args.batch)
    cols = ["atom", "plain_us", "prot_us", "overhead"]
    w = csv.DictWriter(sys.stdout, fieldnames=cols)
    w.writeheader()
    for r in rows:
        w.writerow({k: (round(v, 4) if isinstance(v, float) else v)
                    for k, v in r.items()})
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            wf = csv.DictWriter(f, fieldnames=cols)
            wf.writeheader()
            for r in rows:
                wf.writerow({k: (round(v, 4) if isinstance(v, float) else v)
                             for k, v in r.items()})


if __name__ == "__main__":
    main()
