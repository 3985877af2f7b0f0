"""Evaluator performance suite (profile_framewk/src/framewk.cpp analog):
times every evaluator op for CKKS, BGV, and BFV and prints the familiar
"Average <op>: N microseconds" lines, plus a MicroTest-style registry
(include/microtest.h) for ad-hoc micro-benchmarks.

Usage: python -m rfhe_tpu.bench.perf_suite [ckks|bgv|bfv|all] [--n N] [--levels L]
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Tuple

import numpy as np


class MicroTest:
    """Named micro-benchmark registry (microtest.h analog)."""

    registry: Dict[str, "MicroTest"] = {}

    def __init__(self, name: str, setup: Callable[[], tuple],
                 run: Callable[..., object], iters: int = 20):
        self.name = name
        self.setup = setup
        self.run = run
        self.iters = iters
        MicroTest.registry[name] = self

    def __call__(self) -> float:
        import jax
        args = self.setup()
        out = self.run(*args)            # compile
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(self.iters):
            out = self.run(*args)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / self.iters * 1e6


def _time(fn, iters=10, sync=None) -> float:
    import jax
    out = fn()
    jax.block_until_ready(out) if sync is None else sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out) if sync is None else sync(out)
    return (time.perf_counter() - t0) / iters * 1e6


def ckks_performance_test(n: int = 4096, levels: int = 3,
                          iters: int = 10) -> Dict[str, float]:
    import jax
    from ..fhe import CkksContext, CkksParams
    ckks = CkksContext(CkksParams.make(n=n, levels=levels, q0_bits=30,
                                       scale_bits=28), seed=7)
    rng = np.random.default_rng(0)
    z1 = rng.uniform(-1, 1, n // 2) + 0j
    z2 = rng.uniform(-1, 1, n // 2) + 0j
    results: Dict[str, float] = {}
    t0 = time.perf_counter()
    pt1, sc = ckks.encode(z1)
    results["encode"] = (time.perf_counter() - t0) * 1e6
    pt2, _ = ckks.encode(z2)
    t0 = time.perf_counter()
    ct1 = ckks.encrypt(pt1, sc)
    jax.block_until_ready(ct1.c[0].data)
    results["encrypt"] = (time.perf_counter() - t0) * 1e6
    ct2 = ckks.encrypt(pt2, sc)
    results["add"] = _time(lambda: ckks.add(ct1, ct2).c[0].data, iters)
    results["multiply"] = _time(lambda: ckks.multiply(ct1, ct2).c[0].data, iters)
    results["multiply_relin"] = _time(
        lambda: ckks.multiply_relin(ct1, ct2).c[0].data, iters)
    results["multiply_plain"] = _time(
        lambda: ckks.multiply_plain(ct1, pt2, sc).c[0].data, iters)
    results["square_relin"] = _time(
        lambda: ckks.multiply_relin(ct1, ct1).c[0].data, iters)
    ct3 = ckks.multiply_relin(ct1, ct2)
    results["rescale"] = _time(lambda: ckks.rescale(ct3).c[0].data, iters)
    results["rotate_one"] = _time(lambda: ckks.rotate(ct1, 1).c[0].data, iters)
    results["rotate_random"] = _time(
        lambda: ckks.rotate(ct1, 13).c[0].data, iters)
    results["conjugate"] = _time(lambda: ckks.conjugate(ct1).c[0].data, iters)
    t0 = time.perf_counter()
    ckks.decrypt_decode(ct1)
    results["decrypt_decode"] = (time.perf_counter() - t0) * 1e6
    # serialization rows (framewk.cpp times save/save+zlib/save+zstd; lzma
    # stands in for zstd — not in this image)
    from ..fhe import serialize as _ser
    for comp in ("none", "zlib", "lzma"):
        key = "serialize" if comp == "none" else f"serialize_{comp}"
        results[key] = _time(
            lambda: len(_ser.serialize_ciphertext(ct1, comp)), iters,
            sync=lambda _:None)
    return results


def bgv_performance_test(n: int = 4096, levels: int = 2,
                         iters: int = 10) -> Dict[str, float]:
    import jax
    from ..fhe.params import BgvParams
    from ..fhe.bgv import BgvContext
    bgv = BgvContext(BgvParams.make(n=n, levels=levels, q_bits=30, t_bits=16),
                     seed=11)
    rng = np.random.default_rng(0)
    m1 = rng.integers(0, bgv.t, (2, n // 2), dtype=np.uint32)
    m2 = rng.integers(0, bgv.t, (2, n // 2), dtype=np.uint32)
    results: Dict[str, float] = {}
    t0 = time.perf_counter()
    pt1 = bgv.encode(m1)
    results["batch_encode"] = (time.perf_counter() - t0) * 1e6
    pt2 = bgv.encode(m2)
    t0 = time.perf_counter()
    ct1 = bgv.encrypt(pt1)
    jax.block_until_ready(ct1.c[0].data)
    results["encrypt"] = (time.perf_counter() - t0) * 1e6
    ct2 = bgv.encrypt(pt2)
    results["add"] = _time(lambda: bgv.add(ct1, ct2).c[0].data, iters)
    results["multiply_relin"] = _time(
        lambda: bgv.multiply_relin(ct1, ct2).c[0].data, iters)
    results["multiply_plain"] = _time(
        lambda: bgv.multiply_plain(ct1, pt2).c[0].data, iters)
    ct3 = bgv.multiply_relin(ct1, ct2)
    results["mod_switch"] = _time(
        lambda: bgv.mod_switch_to_next(ct3).c[0].data, iters)
    results["rotate_rows"] = _time(
        lambda: bgv.rotate_rows(ct1, 1).c[0].data, iters)
    results["rotate_columns"] = _time(
        lambda: bgv.rotate_columns(ct1).c[0].data, iters)
    t0 = time.perf_counter()
    bgv.decrypt_decode(ct1)
    results["decrypt_decode"] = (time.perf_counter() - t0) * 1e6
    return results


def bfv_performance_test(n: int = 4096, levels: int = 2,
                         iters: int = 10) -> Dict[str, float]:
    """BFV op timings (framewk.cpp bfv_performance_test surface)."""
    import jax
    from ..fhe.params import BfvParams
    from ..fhe.bfv import BfvContext
    bfv = BfvContext(BfvParams.make(n=n, levels=levels, q_bits=30, t_bits=16),
                     seed=13)
    rng = np.random.default_rng(0)
    m1 = rng.integers(0, bfv.t, (2, n // 2), dtype=np.uint32)
    m2 = rng.integers(0, bfv.t, (2, n // 2), dtype=np.uint32)
    results: Dict[str, float] = {}
    t0 = time.perf_counter()
    pt1 = bfv.encode(m1)
    results["batch_encode"] = (time.perf_counter() - t0) * 1e6
    pt2 = bfv.encode(m2)
    t0 = time.perf_counter()
    ct1 = bfv.encrypt(pt1)
    jax.block_until_ready(ct1.c[0].data)
    results["encrypt"] = (time.perf_counter() - t0) * 1e6
    ct2 = bfv.encrypt(pt2)
    results["add"] = _time(lambda: bfv.add(ct1, ct2).c[0].data, iters)
    results["multiply"] = _time(lambda: bfv.multiply(ct1, ct2).c[0].data,
                                iters)
    results["square"] = _time(lambda: bfv.square(ct1).c[0].data, iters)
    results["multiply_relin"] = _time(
        lambda: bfv.multiply_relin(ct1, ct2).c[0].data, iters)
    results["multiply_plain"] = _time(
        lambda: bfv.multiply_plain(ct1, pt2).c[0].data, iters)
    results["rotate_rows"] = _time(
        lambda: bfv.rotate_rows(ct1, 1).c[0].data, iters)
    results["rotate_columns"] = _time(
        lambda: bfv.rotate_columns(ct1).c[0].data, iters)
    t0 = time.perf_counter()
    bfv.decrypt_decode(ct1)
    results["decrypt_decode"] = (time.perf_counter() - t0) * 1e6
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("scheme", choices=["ckks", "bgv", "bfv", "all"], nargs="?",
                    default="all")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    from . import device
    device.require_gpu()
    print(device.banner())
    if args.scheme in ("ckks", "all"):
        print(f"== CKKS performance (n={args.n}, levels={args.levels}) ==")
        for op, us in ckks_performance_test(args.n, args.levels,
                                            args.iters).items():
            print(f"Average {op}: {us:.0f} microseconds")
    if args.scheme in ("bgv", "all"):
        lv = min(args.levels, 2)
        print(f"== BGV performance (n={args.n}, levels={lv}) ==")
        for op, us in bgv_performance_test(args.n, lv, args.iters).items():
            print(f"Average {op}: {us:.0f} microseconds")
    if args.scheme in ("bfv", "all"):
        lv = min(args.levels, 2)
        print(f"== BFV performance (n={args.n}, levels={lv}) ==")
        for op, us in bfv_performance_test(args.n, lv, args.iters).items():
            print(f"Average {op}: {us:.0f} microseconds")


if __name__ == "__main__":
    main()
