"""Device-time measurement that cancels host dispatch overhead.

Wall-clock timing of single jit calls includes a fixed per-call dispatch
cost, and even lax.fori_loop iterations carry a fixed per-iteration
overhead at small repetition counts.  This estimator takes the SLOPE of
total time vs in-jit repetition count: run body^r1 and body^r2 inside one
jit each and divide the difference — fixed costs cancel exactly.

The reference's timing discipline (amortized loops, e.g.
profile_framewk/src/framewk.cpp count loops around each op), adapted to an
async-dispatch runtime.  Not yet validated against a profiler trace on the
GPU (ROADMAP.md design debt 4).
"""
from __future__ import annotations

import time
from typing import Callable

import jax


def reptime(body: Callable, x, rep: int, iters: int = 8,
            group: int = 4) -> float:
    """Seconds per call of a jit program applying `body` rep times.
    body must be shape-preserving (output pytree == input pytree shape).

    Takes the MIN over `iters` timing groups of `group` chained async calls
    each: chaining amortizes the dispatch latency across the group, and
    the min discards host hiccups (noise here is strictly additive — a mean
    lets one multi-ms stall poison the slope)."""
    from ..utils.jitcache import hoisted_jit

    # hoisted_jit: bodies close over plan tables (digitized NTT matrices,
    # folded twiddles) that plain jax.jit would inline as HLO literals
    f = hoisted_jit(
        lambda v: jax.lax.fori_loop(0, rep, lambda i, a: body(a), v))

    y = f(x)
    jax.block_until_ready(y)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        for _ in range(group):
            y = f(y)
        jax.block_until_ready(y)
        best = min(best, (time.perf_counter() - t0) / group)
    return best


def device_time(body: Callable, x, r1: int = 16, r2: int = 128,
                iters: int = 8) -> float:
    """Estimated device seconds per application of `body` (slope method)."""
    t1 = reptime(body, x, r1, iters)
    t2 = reptime(body, x, r2, iters)
    return max((t2 - t1) / (r2 - r1), 0.0)
