"""Scaling-efficiency harness for the sharded demo four-step NTT
(transform/distributed.py): throughput at device counts 1, 2, 4, ...

Runs on the process's GPUs and fails when there are fewer than --devices.
--rehearse-cpu runs it on virtual CPU devices instead, which validates only
the mechanics (mesh construction, the all_to_all transpose); its output
names platform=cpu.

Usage: python -m rfhe_tpu.bench.scaling [--n 4096] [--limbs 8]
           [--devices 4] [--rehearse-cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def measure(n: int = 1024, limbs: int = 8, iters: int = 20,
            max_devices: int = 4) -> list:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from .. import numth
    from ..transform import FourStepPlan
    from ..transform.distributed import four_step_ntt_sharded

    q = numth.find_ntt_prime(n, 28)
    plan = FourStepPlan.make(n, q)
    rng = np.random.default_rng(0)
    x = rng.integers(0, q, size=(limbs, n), dtype=np.uint32)
    devs = jax.devices()[:max_devices]
    rows = []
    d = 1
    while d <= len(devs) and plan.n1 % d == 0:
        mesh = Mesh(np.array(devs[:d]), ("fft",))
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P()))
        f = jax.jit(lambda v: four_step_ntt_sharded(v, plan, mesh))
        f(xs).block_until_ready()
        t0 = time.perf_counter()
        for _ in range(iters):
            y = f(xs)
        y.block_until_ready()
        dt = (time.perf_counter() - t0) / iters
        ops = limbs / dt
        rows.append({"devices": d, "limb_transforms_per_s": ops})
        d *= 2
    base = rows[0]["limb_transforms_per_s"]
    for r in rows:
        r["efficiency"] = r["limb_transforms_per_s"] / (base * r["devices"])
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--limbs", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--devices", type=int, default=4,
                    help="largest device count to measure")
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run on virtual CPU devices (mechanics only)")
    args = ap.parse_args(argv)
    from . import device
    if args.rehearse_cpu:
        device.rehearse_on_cpu(args.devices)
    else:
        device.require_gpu(args.devices)
    print(device.banner())
    for r in measure(args.n, args.limbs, args.iters, args.devices):
        print(f"devices={r['devices']}: {r['limb_transforms_per_s']:.0f} "
              f"transforms/s, efficiency={r['efficiency']:.2f}")


if __name__ == "__main__":
    main()
