"""Constant-hoisting jit: compile closures over multi-hundred-MB tables.

The scheme layer's jitted ops close over static plan tables (digitized NTT
stage matrices, folded twiddles, rescale constants).  jax.jit inlines
closed-over concrete arrays into the lowered module as dense literals, so a
single 34-limb N=65536 NTT lowers to a ~365 MB StableHLO, which the
compiler would chew on needlessly (and some compile services reject
outright for size).

hoisted_jit traces the function once with jax.make_jaxpr, pulls the
captured constants out of the ClosedJaxpr, and re-evaluates the jaxpr under
jit with those constants passed as ordinary ARGUMENTS — they become runtime
parameters (device-resident buffers) instead of program literals.  Same
math, tiny HLO.  (jax.closure_convert does NOT do this: it only hoists
tracers from an outer trace, not concrete arrays.)
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import tree_util


class HoistedJit:
    """Callable wrapping `fn` with constants hoisted to jit arguments.
    Traced lazily on first call; retraces if the input tree/shapes change.

    NOTE: the closure is FROZEN at first trace per (treedef, avals) key —
    constants captured by `fn` at that call are reused on every later call
    with the same signature.  Callers that rebuild closures over different
    tables per call must bake the distinguishing data into the *arguments*
    (as ckks.encrypt_seeded does), not the closure."""

    def __init__(self, fn: Callable):
        self._fn = fn
        self._cache = {}             # (in_treedef, avals) -> (jitted, consts, out_tree)

    def __call__(self, *args):
        flat, in_tree = tree_util.tree_flatten(args)
        # Inside an active JAX trace (a caller's jit/vmap is tracing us),
        # hoisting is both pointless (we are already being staged) and
        # HARMFUL: make_jaxpr would capture values materialized under the
        # outer trace (e.g. jnp.asarray of a host table) as "constants"
        # that are really outer-trace tracers, poisoning the cache for
        # every later call with the same signature.  Inline instead.
        if any(isinstance(a, jax.core.Tracer) for a in flat):
            return self._fn(*args)
        run, consts, out_tree = self._entry(flat, in_tree)
        return tree_util.tree_unflatten(out_tree, run(consts, flat))

    def lower(self, *args):
        """`jax.stages.Lowered` of the hoisted program for `args`; its
        `.compile()` gives the optimized HLO text and memory analysis."""
        flat, in_tree = tree_util.tree_flatten(args)
        run, consts, _ = self._entry(flat, in_tree)
        return run.lower(consts, flat)

    def _entry(self, flat, in_tree):
        sig = (in_tree,) + tuple(
            (getattr(a, "shape", None), getattr(a, "dtype", None))
            for a in flat)
        entry = self._cache.get(sig)
        if entry is None:
            out_store = {}

            def flat_fn(*f):
                out = self._fn(*tree_util.tree_unflatten(in_tree, f))
                out_flat, out_tree = tree_util.tree_flatten(out)
                out_store["tree"] = out_tree
                return out_flat

            closed = jax.make_jaxpr(flat_fn)(*flat)
            consts = [jnp.asarray(c) for c in closed.consts]
            jaxpr = closed.jaxpr

            @jax.jit
            def run(consts, flat_args):
                return jax.core.eval_jaxpr(jaxpr, consts, *flat_args)

            entry = (run, consts, out_store["tree"])
            self._cache[sig] = entry
        return entry


def hoisted_jit(fn: Callable) -> HoistedJit:
    return HoistedJit(fn)
