"""Device-true rotation phase breakdown via the slope method (VERDICT
round-2 item #3 — replaces trace/profiled.py's per-phase host timings,
whose separately-dispatched phases each paid a per-call dispatch cost
and produced N-independent totals).

Each keyswitch phase is wrapped in a shape-preserving body and timed with
bench/devtime.device_time (total time of body^r inside ONE jit at two
repetition counts; the slope cancels dispatch cost exactly).  Wrappers add
O(L·N) glue (an add / slice / concat) to keep the phase's work live across
fori_loop iterations without materializing new buffers — bias well under
the phases' own cost.  Values become garbage after the first rep; every op
in the pipeline is data-independent (branch-free u32 arithmetic), so the
timing is unaffected.

Phases (reference kernel-line categories, profile_framewk sum_trace):
  PERMUTE   galois slot gather
  INTT      c1 to coefficient domain
  BASECONV  digit extension to the (Q, p) basis
  NTT       forward transform of all digits
  MULTEVK   two dyadic MACs against the key + digit tree-sums
  MODDOWN   divide-and-round by the special prime
Mapping to draw_rotation.py's shares: NTT = INTT+NTT, ModMul = MULTEVK,
BaseConv = BASECONV, Others = PERMUTE+MODDOWN.

Usage:
  python -m rfhe_tpu.bench.phase_profile rotation --ns 2048,4096,...,65536
      --limbs 21 [--csv results/rotation_profile.csv]
  python -m rfhe_tpu.bench.phase_profile dnum --n 4096 --limbs 21
      --dnums 2,3,4,6,8,12,24 [--csv results/dnum_N4096.csv]
"""
from __future__ import annotations

import argparse
import csv
import sys
from typing import Dict


def _phase_times(ckks, level: int, r1: int = 4, r2: int = 32,
                 iters: int = 6) -> Dict[str, float]:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ..fhe.keys import _basis_plan, _sum_digits, compute_digits
    from ..fhe.rns import drop_limb
    from ..ops import u32
    from ..ops.ntt_pease import negacyclic_intt, negacyclic_ntt
    from .devtime import device_time

    ctx = ckks.ctx
    n = ckks.params.n
    L = ckks.L
    n_sp = len(ctx.moduli) - L
    sp_idx = list(range(L, L + n_sp))
    active = level + 1
    lim = list(range(active)) + sp_idx
    sub_plan = _basis_plan(ctx, lim)
    plan = ctx.plan.slice(active)
    g = ckks.rotation_galois_element(1)
    perm = jnp.asarray(ctx.galois_perm(g))
    ksk = ckks.galois_key(g)
    lim_idx = jnp.asarray(lim)
    dig0, used, _ = compute_digits(
        jnp.zeros((active, n), jnp.uint32), level, ctx, L, ckks.dnum)
    used_idx = jnp.asarray(used)
    kb = ksk.b[used_idx][:, lim_idx]
    ka = ksk.a[used_idx][:, lim_idx]
    q_lim = sub_plan.q_arr[:, None]

    rng = np.random.default_rng(0)
    x_act = jnp.asarray(np.stack([
        rng.integers(0, int(ctx.moduli[i]), n, dtype=np.uint32)
        for i in range(active)]))
    x_dig = jnp.asarray(np.stack([np.stack([
        rng.integers(0, int(ctx.moduli[i]), n, dtype=np.uint32)
        for i in lim]) for _ in used]))
    x_acc = jnp.asarray(np.stack([
        rng.integers(0, int(ctx.moduli[i]), n, dtype=np.uint32)
        for i in lim]))

    def t(body, x):
        # adaptive reps: a 0.0 slope means the phase's signal fell below
        # host noise at this rep count (round-4 verdict weak #7: the
        # committed N=16384 MODDOWN cell) — escalate r by 4x until the
        # measurement resolves (two escalations = 16x the configured reps)
        a, b = r1, r2
        for _ in range(3):
            v = device_time(body, x, r1=a, r2=b, iters=iters)
            if v > 0.0:
                return v
            a, b = a * 4, b * 4
        return v

    out: Dict[str, float] = {}
    out["PERMUTE"] = t(lambda c: c[:, perm], x_act)
    out["INTT"] = t(lambda c: negacyclic_intt(c, plan), x_act)

    def baseconv(d):
        dig, _, _ = compute_digits(d, level, ctx, L, ckks.dnum)
        # fold the (D, n_lim, N) digits back onto the (active, N) input:
        # keeps every extension limb live (no DCE), adds D*n_lim*N wrapping
        # adds, and is shape-preserving for any digit count (dnum sweeps)
        return d + jnp.sum(dig.astype(jnp.uint32), axis=(0, 1))[None, :]

    out["BASECONV"] = t(baseconv, x_act)
    out["NTT"] = t(lambda d: negacyclic_ntt(d, sub_plan), x_dig)

    def multevk(dn):
        qinv = sub_plan.qinv_arr[:, None]
        t0 = u32.mont_mul(dn, kb, q_lim, qinv)
        t1 = u32.mont_mul(dn, ka, q_lim, qinv)
        a0 = _sum_digits(t0, q_lim)
        a1 = _sum_digits(t1, q_lim)
        return dn + a0[None] + a1[None]        # wrapping glue, keeps both live

    out["MULTEVK"] = t(multevk, x_dig)

    def moddown(acc):
        a = acc
        for k_i in range(n_sp - 1, -1, -1):
            keep = list(range(active)) + sp_idx[:k_i]
            a = drop_limb(a, sp_idx[k_i], keep, ctx)
        return jnp.concatenate([a, acc[a.shape[0]:]], axis=0)

    out["MODDOWN"] = t(moddown, x_acc)

    # Mod-down decomposed by KERNEL CLASS (the reference's sum_trace.py
    # aggregates [NTT]/[BASECONV]/[MODREDUCTION] tags wherever they occur,
    # including inside SEAL's mod-down — without this split the dnum ramp's
    # low-dnum rows, where α = ceil(L/dnum) special primes dominate the
    # mod-down, would dump the NTT/BaseConv work hiding in drop_limb into
    # "Others").  Each body mirrors drop_limb's α-iteration loop shapes
    # (rns.drop_limb: 1-limb INTT → lift_to_limbs over K_i kept limbs →
    # K_i-limb delta NTT → sub + Shoup scale) with wrapping-add glue.
    from ..fhe.rns import lift_to_limbs, limb_plan

    def md_intt(acc):
        add = jnp.zeros_like(acc[0])
        for k_i in range(n_sp - 1, -1, -1):
            row = negacyclic_intt(acc[active + k_i:active + k_i + 1],
                                  limb_plan(ctx, sp_idx[k_i]))
            add = add + row[0]
        return acc + add[None, :]

    def md_baseconv(acc):
        add = jnp.zeros_like(acc[0])
        for k_i in range(n_sp - 1, -1, -1):
            keep = list(range(active)) + sp_idx[:k_i]
            delta = lift_to_limbs(acc[active + k_i], sp_idx[k_i], keep, ctx,
                                  centered=True)
            add = add + jnp.sum(delta, axis=0)
        return acc + add[None, :]

    def md_ntt(acc):
        add = jnp.zeros_like(acc[0])
        for k_i in range(n_sp - 1, -1, -1):
            keep = list(range(active)) + sp_idx[:k_i]
            dn = negacyclic_ntt(acc[:len(keep)], ctx.plan.take(keep))
            add = add + jnp.sum(dn, axis=0)
        return acc + add[None, :]

    def md_modmul(acc):
        add = jnp.zeros_like(acc[0])
        for k_i in range(n_sp - 1, -1, -1):
            keep = list(range(active)) + sp_idx[:k_i]
            kidx = np.asarray(keep)
            q_lo = ctx.plan.q_arr[kidx, None]
            src = sp_idx[k_i]
            num = u32.sub_mod(acc[:len(keep)], acc[1:len(keep) + 1], q_lo)
            s = u32.mul_mod_shoup(num, ctx.qk_inv[src][kidx, None],
                                  ctx.qk_inv_shoup[src][kidx, None], q_lo)
            add = add + jnp.sum(s, axis=0)
        return acc + add[None, :]

    if n_sp > 0:
        out["MD_INTT"] = t(md_intt, x_acc)
        out["MD_BASECONV"] = t(md_baseconv, x_acc)
        out["MD_NTT"] = t(md_ntt, x_acc)
        out["MD_MODMUL"] = t(md_modmul, x_acc)
    return out


def rotation_total_checked(ckks, level: int, phase_sum: float,
                           r1: int = 4, r2: int = 32) -> float:
    """rotation_total with a consistency retry: the fused total can never
    be under half the sum of its own phases, so a slope that low is a
    measurement hiccup (a near-zero slope was once observed at dnum=1) —
    re-measure up to 3 times and keep the first sane value."""
    tot = 0.0
    for _ in range(3):
        tot = rotation_total(ckks, level, r1=r1, r2=r2)
        if tot >= 0.5 * phase_sum:
            return tot
    return tot


def rotation_total(ckks, level: int, r1: int = 4, r2: int = 32,
                   iters: int = 6) -> float:
    """Device time of the full fused rotation (shape-preserving by nature)."""
    import jax.numpy as jnp
    import numpy as np
    from ..fhe.ckks import Ciphertext
    from ..fhe.rns import RnsPoly
    from .devtime import device_time

    n = ckks.params.n
    rng = np.random.default_rng(1)
    cs = [jnp.asarray(np.stack([
        rng.integers(0, int(ckks.ctx.moduli[i]), n, dtype=np.uint32)
        for i in range(level + 1)])) for _ in range(2)]
    g = ckks.rotation_galois_element(1)
    ksk = ckks.galois_key(g)

    def body(c01):
        ct = Ciphertext([RnsPoly(c01[0], True), RnsPoly(c01[1], True)], 1.0)
        out = ckks._apply_galois_impl(ct, ksk, g)
        return jnp.stack([out.c[0].data, out.c[1].data])

    return device_time(body, jnp.stack(cs), r1=r1, r2=r2, iters=iters)


def _shares(ph: Dict[str, float]) -> Dict[str, float]:
    """Kernel-class shares (reference categories, draw_rotation.py:10-15).
    When the measured mod-down decomposition is present (MD_*), its INTT/
    NTT/BaseConv/ModMul constituents count toward those classes — the same
    attribution the reference's sum_trace.py applies to SEAL's [NTT]/
    [BASECONV] kernel tags inside mod_switch — and only the unattributed
    residual stays in Others."""
    md = [ph.get(k, 0.0) for k in ("MD_INTT", "MD_BASECONV", "MD_NTT",
                                   "MD_MODMUL")]
    md_scale = min(1.0, ph["MODDOWN"] / sum(md)) if sum(md) > 0 else 0.0
    mdi, mdb, mdn, mdm = (v * md_scale for v in md)
    ntt = ph["NTT"] + ph["INTT"] + mdi + mdn
    modmul = ph["MULTEVK"] + mdm
    baseconv = ph["BASECONV"] + mdb
    others = ph["PERMUTE"] + max(ph["MODDOWN"] - (mdi + mdb + mdn + mdm),
                                 0.0)
    s = ntt + modmul + baseconv + others
    return {"NTT": ntt / s, "ModMul": modmul / s, "BaseConv": baseconv / s,
            "Others": others / s, "sum_us": s * 1e6}


def _write(path, cols, rows):
    w = csv.DictWriter(sys.stdout, fieldnames=cols)
    w.writeheader()
    for r in rows:
        w.writerow(r)
    if path:
        with open(path, "w", newline="") as f:
            wf = csv.DictWriter(f, fieldnames=cols)
            wf.writeheader()
            for r in rows:
                wf.writerow(r)
        print("wrote", path, file=sys.stderr)


def main(argv=None) -> None:
    from ..utils.compilecache import enable_compilation_cache
    enable_compilation_cache()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cmd", choices=["rotation", "dnum"])
    ap.add_argument("--ns", default="2048,4096,8192,16384,32768,65536")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--limbs", type=int, default=21)
    ap.add_argument("--dnums", default="2,3,4,6,8,12,24")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--r2", type=int, default=32)
    args = ap.parse_args(argv)
    from . import device
    device.require_gpu()
    print(device.banner())
    from ..fhe.ckks import CkksContext
    from ..fhe.params import CkksParams

    rows = []
    cols = ["n", "limbs", "dnum", "PERMUTE_us", "INTT_us", "BASECONV_us",
            "NTT_us", "MULTEVK_us", "MODDOWN_us", "MD_INTT_us",
            "MD_BASECONV_us", "MD_NTT_us", "MD_MODMUL_us", "total_us",
            "NTT", "ModMul", "BaseConv", "Others"]
    if args.cmd == "rotation":
        for n in [int(v) for v in args.ns.split(",")]:
            # levels = limbs-1: CkksParams.make gives L = levels+1 ct limbs
            # (the reference profiles 21 limbs at EVERY polydim,
            # draw_rotation.py:10-20)
            limbs = args.limbs
            params = CkksParams.make(n=n, levels=limbs - 1)
            ckks = CkksContext(params)
            level = ckks.L - 1
            # scale reps to the phase cost: at small n each phase is tens
            # of us, so the r2=32 slope drowns in host noise (observed as
            # MULTEVK 0.0 at n=2048); keep r2 * phase_cost ~ 10+ ms
            r2 = max(args.r2, min(256, (1 << 21) // n))
            r1 = max(4, r2 // 8)
            ph = _phase_times(ckks, level, r1=r1, r2=r2)
            sh = _shares(ph)
            tot = rotation_total_checked(ckks, level, sh["sum_us"] * 1e-6,
                                         r1=r1, r2=r2)
            rows.append({
                "n": n, "limbs": ckks.L, "dnum": "",
                **{f"{k}_us": round(v * 1e6, 2) for k, v in ph.items()},
                "total_us": round(tot * 1e6, 2),
                **{k: round(sh[k], 4) for k in
                   ("NTT", "ModMul", "BaseConv", "Others")},
            })
            print(rows[-1], file=sys.stderr, flush=True)
    else:
        for dnum in [int(v) for v in args.dnums.split(",")]:
            params = CkksParams.make(n=args.n, levels=args.limbs - 1)
            ckks = CkksContext(params, dnum=dnum)
            level = ckks.L - 1
            r2 = max(args.r2, min(256, (1 << 21) // args.n))
            r1 = max(4, r2 // 8)
            ph = _phase_times(ckks, level, r1=r1, r2=r2)
            sh = _shares(ph)
            tot = rotation_total_checked(ckks, level, sh["sum_us"] * 1e-6,
                                         r1=r1, r2=r2)
            rows.append({
                "n": args.n, "limbs": ckks.L, "dnum": dnum,
                **{f"{k}_us": round(v * 1e6, 2) for k, v in ph.items()},
                "total_us": round(tot * 1e6, 2),
                **{k: round(sh[k], 4) for k in
                   ("NTT", "ModMul", "BaseConv", "Others")},
            })
            print(rows[-1], file=sys.stderr, flush=True)
    _write(args.csv, cols, rows)


if __name__ == "__main__":
    main()
