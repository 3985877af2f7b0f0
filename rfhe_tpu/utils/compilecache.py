"""Persistent XLA compilation cache for the benchmark / campaign drivers
(the BGV N=16384 dot product takes minutes to build cold; sweeps recompile
the same programs every run).

JAX's persistent cache keys on (HLO, compile options, backend version), so
re-running a benchmark with unchanged shapes loads the compiled executable from
disk instead of rebuilding it.  Call once at driver startup; tests don't
need it (CPU compiles are cheap and the cache would churn).

Where the cache lives:
  * JAX_COMPILATION_CACHE_DIR set: JAX reads it itself; this module sets no
    other directory.
  * unset: one fixed directory inside the checkout, `<repo>/.jax_cache/`
    (git-ignored).  The path is part of what makes a later run hit, so it is
    never temporary, per-process or time-stamped.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses (env var, else the fixed
    in-checkout path)."""
    return os.environ.get(ENV_VAR) or REPO_CACHE_DIR


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache (idempotent); returns the
    directory in use."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    # cache everything that took noticeable compile time
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
