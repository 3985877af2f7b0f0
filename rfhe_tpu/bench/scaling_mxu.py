"""Scaling-efficiency artifact for the PRODUCTION sharded NTT.

Measures `transform/mxu_sharded.mxu_ntt_sharded` — the kernel class the
scheme layer actually runs, sharded over the mesh — at device counts
1..D_max, plus the all_to_all stage-boundary collective in isolation so
its share of the total is a tracked number (the ≥80%-scaling north star,
SURVEY.md §2.6; the reference's only parallelism is the CUDA limb-batch
axis, reliability_test/ntt_test.cu:44-95).

Runs on the process's GPUs (all-to-all over NVLink) and fails when there
are fewer than --devices.  --rehearse-cpu runs the same driver on virtual
CPU devices instead; that validates only the *mechanics* (shard_map
layouts, the single all_to_all per transform, efficiency accounting), and
its output names platform=cpu.  Writes one CSV row per device count:

  devices,total_us,a2a_us,a2a_share,limb_transforms_per_s,efficiency

Usage: python -m rfhe_tpu.bench.scaling_mxu [--n 4096] [--limbs 12]
           [--devices 4] [--rehearse-cpu] [--csv out.csv]
"""
from __future__ import annotations

import argparse
import csv
import sys
import time


def _time(f, x, iters: int) -> float:
    f(x).block_until_ready()                    # compile + warm
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        f(x).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return best


def measure(n: int, limbs: int, iters: int, max_devices: int) -> list:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    try:
        from jax import shard_map as _shard_map
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map as _shard_map

    from .. import numth
    from ..ops.ntt_mxu import MxuNttPlan
    from ..transform.mxu_sharded import mxu_ntt_sharded

    primes = numth.find_ntt_primes(n, 30, limbs)
    plan = MxuNttPlan.make(n, primes)
    n1, n2 = plan.n1, plan.n2
    rng = np.random.default_rng(0)
    qmin = int(np.asarray(plan.q_arr).min())
    x = jnp.asarray(rng.integers(0, qmin, (limbs, n), dtype=np.uint32))

    devs = jax.devices()[:max_devices]
    rows = []
    d = 1
    while d <= len(devs) and n1 % d == 0 and n2 % d == 0:
        mesh = Mesh(np.array(devs[:d]), ("fft",))
        xs = jax.device_put(x, NamedSharding(mesh, P()))
        f = jax.jit(lambda v: mxu_ntt_sharded(v, plan, mesh))
        total = _time(f, xs, iters)

        # the stage-boundary collective in isolation: same per-device shard
        # shape as Bm inside the kernel ((L, n2, n1/d) u32 slabs)
        def a2a_local(B):
            return jax.lax.all_to_all(B, "fft", split_axis=B.ndim - 2,
                                      concat_axis=B.ndim - 1, tiled=True)

        B = jnp.asarray(rng.integers(0, qmin, (limbs, n2, n1),
                                     dtype=np.uint32))
        Bs = jax.device_put(B, NamedSharding(mesh, P(None, None, "fft")))
        g = jax.jit(_shard_map(a2a_local, mesh=mesh,
                               in_specs=P(None, None, "fft"),
                               out_specs=P(None, "fft", None)))
        a2a = _time(g, Bs, iters) if d > 1 else 0.0

        rows.append({"devices": d, "total_us": round(total * 1e6, 1),
                     "a2a_us": round(a2a * 1e6, 1),
                     "a2a_share": round(a2a / total, 4),
                     "limb_transforms_per_s": round(limbs / total, 1)})
        print(rows[-1], file=sys.stderr, flush=True)
        d *= 2
    base = rows[0]["limb_transforms_per_s"]
    for r in rows:
        r["efficiency"] = round(
            r["limb_transforms_per_s"] / (base * r["devices"]), 4)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--limbs", type=int, default=12)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--devices", type=int, default=4,
                    help="largest device count to measure")
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run on virtual CPU devices (mechanics only)")
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    from . import device
    if args.rehearse_cpu:
        device.rehearse_on_cpu(args.devices)
    else:
        device.require_gpu(args.devices)
    print(device.banner())
    rows = measure(args.n, args.limbs, args.iters, args.devices)
    cols = ["devices", "total_us", "a2a_us", "a2a_share",
            "limb_transforms_per_s", "efficiency"]
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
        print("wrote", args.csv, file=sys.stderr)


if __name__ == "__main__":
    main()
