"""Headline benchmark: CKKS rotation latency on one GPU vs the reference's
SEAL 4.1 CPU measurement.

Prints the device (platform, device_kind, count, and the card's name and
power limit from nvidia-smi), then ONE JSON line
{"metric", "value", "unit", "vs_baseline"} last, and exits nonzero on ANY
failure — no silent fallback, and no number from a CPU.

Baseline (BASELINE.md / profile_framewk/draw_rotation.py:59): CKKS rotation
at N=4096 with 21 RNS limbs costs 14,377 µs on the reference's CPU build
(SEAL 4.1 Debug -O0 profiling build — see BASELINE.md for the caveat).
We measure the same op (apply_galois: slot permutation + full hybrid
keyswitch with 21 digits) warm on one GPU, wall-clock amortized over
pipelined dispatches.  vs_baseline = baseline_us / ours_us (>1 beats SEAL).
"""
from __future__ import annotations

import json
import time

import numpy as np

BASELINE_ROTATION_US = 14_377.0   # SEAL 4.1, N=4096, 21 limbs (CPU)


def headline_context(n: int = 4096, levels: int = 20):
    """The headline config: 21 ciphertext limbs + 1 special at N=4096
    (smaller shapes are for CPU tests)."""
    from rfhe_tpu.fhe import CkksContext, CkksParams
    params = CkksParams.make(n=n, levels=levels, q0_bits=30, scale_bits=28)
    return CkksContext(params, seed=7)


def rotation_bench(ckks) -> dict:
    """Warm rotation latency of one ciphertext under `ckks`; refuses to
    report a number for a wrong rotation."""
    import jax

    n, levels = ckks.params.n, ckks.L - 1
    rng = np.random.default_rng(0)
    z = rng.uniform(-1, 1, n // 2) + 0j
    ct = ckks.encrypt(*ckks.encode(z))
    r = ckks.rotate(ct, 1)          # compile + build the galois key
    jax.block_until_ready(r.c[0].data)
    # sanity: the rotation must actually rotate (a perf number for a wrong
    # answer is worthless)
    back = ckks.decrypt_decode(r)
    if not np.allclose(back, np.roll(z, -1), atol=1e-3):
        raise RuntimeError("rotation output mismatch — refusing to report")
    iters = 30
    t0 = time.perf_counter()
    for _ in range(iters):
        r = ckks.rotate(ct, 1)
    jax.block_until_ready(r.c[0].data)
    us = (time.perf_counter() - t0) / iters * 1e6
    return {
        "metric": f"ckks_rotation_n{n}_L{levels + 1}_latency",
        "value": round(us, 1),
        "unit": "us",
        "vs_baseline": round(BASELINE_ROTATION_US / us, 2),
    }


def main() -> None:
    from rfhe_tpu.utils.compilecache import enable_compilation_cache
    enable_compilation_cache()
    from rfhe_tpu.bench import device
    device.require_gpu()            # any exception propagates: fail loudly
    print(device.banner())
    print("# gpu:", device.gpu_name_and_power_limit())
    print(json.dumps(rotation_bench(headline_context())))


if __name__ == "__main__":
    main()
