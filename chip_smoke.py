"""Smoke test of the main path on one GPU: NTT, CKKS, BGV, protected path.

    python chip_smoke.py              # one GPU, phases 0-5
    python chip_smoke.py --multichip  # four GPUs: sharded NTT + sharded CKKS

Every phase runs the library's normal entry points at full width and
compares with the repo's plain reference (rfhe_tpu.oracle, the Pease NTT,
the plaintext numpy computation, the unprotected evaluator).  Any failing
check raises, so the script exits non-zero and prints no result.  The last
line of stdout is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

All work runs in this one process; the only child process is nvidia-smi,
which never touches JAX.  The phase functions take their sizes as
arguments so the CPU tests (tests/test_chip_smoke.py) can run them small.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# Full-width shapes (see PERF.md "Cells").
NTT_SHAPES = ((4096, 20, 30, 28), (65536, 16, 31, 56))  # (n, levels, q0, scale)
CKKS_NORTHSTAR = dict(n=65536, levels=16, q0_bits=31, scale_bits=56)
CKKS_TOL = 1e-6                      # tests/test_northstar.py bound
# The reference campaign's N=16384 built in 215.5 s cold on one H100
# (PERF.md), which with the other phases passed the run's time limit, so
# the smoke runs the same chain at N=4096.
BGV_SHAPE = dict(n=4096, levels=9, q_bits=30, t_bits=20)
CAMPAIGN = dict(n=1024, levels=3, trials=1024)
# 2 + 2*3 = 8 limbs: the 4-way limb mesh must divide the limb count
# (device_put refuses 34 over 4), and the program's size (and compile time)
# grows with the square of the limb count, so the sharded evaluator runs a
# short chain at the full ring dimension.
MULTI_CKKS = dict(n=65536, levels=3, q0_bits=31, scale_bits=56)
MULTI_NTT = (65536, 16, 31, 56)


def result_line(info: dict) -> str:
    """The last line of stdout: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}})


def log(line: str) -> None:
    # one write per line: phases run in several threads
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def _ready(x):
    import jax
    return jax.block_until_ready(x)


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _timed(fn, iters: int) -> float:
    """Warm seconds per call, each call waited for (latency, not
    throughput)."""
    t0 = time.perf_counter()
    for _ in range(iters):
        _ready(fn())
    return (time.perf_counter() - t0) / iters


def _first(fn):
    """(result, seconds) of a first call: trace + compile (or cache load)
    + run."""
    t0 = time.perf_counter()
    out = _ready(fn())
    return out, time.perf_counter() - t0


_NO_LAUNCH = ("parameter", "constant", "tuple", "get-tuple-element",
              "bitcast", "opt-barrier")


def hlo_findings(text: str) -> dict:
    """What one compiled program launches, read from its optimized HLO:
    fusions, custom calls and other non-plumbing ops in the entry
    computation (each is one kernel or library call), the custom-call
    targets and fusion emitters, and any floating-point dot (which a GPU
    may run in TF32)."""
    entry = text[text.index("ENTRY"):] if "ENTRY" in text else text
    entry = entry[:entry.index("\n}") if "\n}" in entry else len(entry)]
    ops = re.findall(r"=\s*[\w\[\]{},:\s()]*?\s([a-z][\w-]*)\(", entry)
    n_fusion = sum(op == "fusion" for op in ops)
    n_custom = sum(op == "custom-call" for op in ops)
    # every other entry op that is not plumbing is a launch of its own
    n_other = sum(op not in _NO_LAUNCH + ("fusion", "custom-call")
                  for op in ops)
    targets = sorted(set(re.findall(r'custom_call_target="([^"]+)"', text)))
    # custom fusions name their emitter in the backend config, e.g.
    # "kind":"__triton_gemm"; cuBLAS calls are custom-call targets
    backend_kinds = sorted(set(re.findall(r'"kind":"(__[\w$]+)"', text)))
    fusion_kinds = sorted(set(re.findall(r"kind=(k\w+)", entry)))
    float_dots = re.findall(r"(?:f32|bf16|f16|f64)\[[^\]]*\][^=\n]*?\sdot\(",
                            text)
    float_gemms = [ln for ln in text.splitlines()
                   if "__cublas" in ln and re.search(r"=\s*\(?(f32|bf16)", ln)]
    return {"fusions": n_fusion, "custom_calls": n_custom,
            "other_ops": n_other, "kernels": n_fusion + n_custom + n_other,
            "custom_call_targets": targets,
            "backend_kinds": backend_kinds, "fusion_kinds": fusion_kinds,
            "plain_dots": len(re.findall(r"\sdot\(", text)),
            "float_dots": len(float_dots) + len(float_gemms)}


def _ntt_chain(n: int, levels: int, q0_bits: int, scale_bits: int):
    from rfhe_tpu.fhe import CkksParams
    return list(CkksParams.make(n=n, levels=levels, q0_bits=q0_bits,
                                scale_bits=scale_bits).moduli)


def _adversarial(primes, n: int, seed: int = 0xF5ED) -> np.ndarray:
    """(3, L, n): random, all q-1, and a lone q-1 spike (plus a 1 at n/2) —
    the extremes that maximize every partial product and carry path."""
    rng = np.random.default_rng(seed)
    qarr = np.asarray(primes, dtype=np.uint32)
    rand = np.stack([rng.integers(0, q, n, dtype=np.uint32) for q in primes])
    full = np.broadcast_to((qarr - 1)[:, None], (len(primes), n)).copy()
    spike = np.zeros((len(primes), n), dtype=np.uint32)
    spike[:, 0] = qarr - 1
    spike[:, n // 2] = 1
    return np.stack([rand, full, spike])


def phase_device() -> dict:
    """Phase 0: the default backend must be a GPU (no CPU fallback)."""
    from rfhe_tpu.bench import device
    from rfhe_tpu.utils.compilecache import cache_dir
    info = device.require_gpu()
    log(f"[device] platform={info['platform']} device_kind={info['kind']} "
        f"count={info['count']}")
    log(f"[device] compile cache: {cache_dir()}")
    return info


def phase_ntt(n: int, levels: int, q0_bits: int, scale_bits: int,
              oracle_limbs: int = 1, iters: int = 20,
              hbm_bytes_per_s: float | None = None) -> dict:
    """Phase 1: production NTT (MxuNttPlan) on the chain's primes, bit-exact
    against the Pease NTT, the host oracle (first `oracle_limbs` limbs) and
    its own inverse, on the adversarial batch.  Reports kernels per
    transform, warm time per (L, n) transform (over the batch of 3), and
    the same for Pease; with
    the device's HBM peak, also each time over the 8 bytes/coefficient
    floor (read + write one u32)."""
    import jax.numpy as jnp
    from rfhe_tpu import oracle
    from rfhe_tpu.numth import PrimeCtx
    from rfhe_tpu.ops import ntt_pease
    from rfhe_tpu.ops.ntt_mxu import MxuNttPlan
    from rfhe_tpu.utils.jitcache import hoisted_jit

    primes = _ntt_chain(n, levels, q0_bits, scale_bits)
    L = len(primes)
    t0 = time.perf_counter()
    plan = MxuNttPlan.make(n, primes)
    pplan = ntt_pease.PeaseNttPlan.make(n, primes)
    build_s = time.perf_counter() - t0
    fwd, inv = hoisted_jit(plan.fwd), hoisted_jit(plan.inv)
    pfwd = hoisted_jit(lambda v: ntt_pease.negacyclic_ntt(v, pplan))

    x = jnp.asarray(_adversarial(primes, n))
    y, fwd_first_s = _first(lambda: fwd(x))
    xr, inv_first_s = _first(lambda: inv(y))
    if not bool(jnp.array_equal(xr, x)):
        raise AssertionError(f"NTT n={n} L={L}: inv(fwd(x)) != x")
    yp = np.asarray(pfwd(x))
    nat = np.empty_like(yp)
    nat[..., pplan.nu] = yp
    y_np = np.asarray(y)
    if not np.array_equal(y_np, nat[..., plan.nu]):
        raise AssertionError(f"NTT n={n} L={L}: MxuNttPlan.fwd != Pease")
    R = 1 << 32
    x_np = np.asarray(x)
    for li in range(oracle_limbs):
        q = primes[li]
        psi = PrimeCtx.make(q, n).psi
        for v in range(x_np.shape[0]):
            ref = np.array([(c * R) % q for c in oracle.negacyclic_ntt(
                [int(a) for a in x_np[v, li]], psi, q)], dtype=np.uint32)
            if not np.array_equal(y_np[v, li], ref[plan.nu]):
                raise AssertionError(
                    f"NTT n={n}: limb {li} vector {v} != oracle")

    # the programs already ran on this batch: lowering again hits the
    # trace and compile caches.  Times are per (L, n) transform, taken on
    # the batch of 3 so no other shape needs compiling.
    hlo_fwd = hlo_findings(fwd.lower(x).compile().as_text())
    hlo_inv = hlo_findings(inv.lower(y).compile().as_text())
    b = x.shape[0]
    t_fwd = _timed(lambda: fwd(x), iters) / b
    t_inv = _timed(lambda: inv(y), iters) / b
    t_pease = _timed(lambda: pfwd(x), iters) / b
    res = {"n": n, "limbs": L, "plan_build_s": build_s,
           "fwd_first_s": fwd_first_s, "inv_first_s": inv_first_s,
           "fwd_us": t_fwd * 1e6, "inv_us": t_inv * 1e6,
           "pease_fwd_us": t_pease * 1e6,
           "hlo_fwd": hlo_fwd, "hlo_inv": hlo_inv,
           "peak_bytes_in_use": _peak_bytes(), "bit_exact": True}
    if hbm_bytes_per_s:
        floor_s = 8 * L * n / hbm_bytes_per_s
        res.update(hbm_floor_us=floor_s * 1e6, fwd_over_floor=t_fwd / floor_s,
                   inv_over_floor=t_inv / floor_s,
                   pease_over_floor=t_pease / floor_s)
    log(f"[ntt] {json.dumps(res)}")
    return res


def phase_ckks(n: int, levels: int, q0_bits: int, scale_bits: int,
               tol: float = CKKS_TOL, iters: int = 5) -> dict:
    """Phase 2: encode → encrypt → multiply_relin → rescale → rotate(1) →
    decrypt_decode against the plaintext numpy result."""
    from rfhe_tpu.fhe import CkksContext, CkksParams

    t0 = time.perf_counter()
    params = CkksParams.make(n=n, levels=levels, q0_bits=q0_bits,
                             scale_bits=scale_bits)
    ckks = CkksContext(params, seed=7)
    g = ckks.rotation_galois_element(1)
    _ = ckks.rlk, ckks.galois_key(g)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    z = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
    pt, sc = ckks.encode(z)

    first, warm = {}, {}
    ct, first["encrypt"] = _first(lambda: ckks.encrypt(pt, sc))
    m, first["multiply_relin"] = _first(lambda: ckks.multiply_relin(ct, ct))
    r, first["rescale"] = _first(lambda: ckks.rescale(m))
    rot, first["rotate"] = _first(lambda: ckks.rotate(r, 1))
    t1 = time.perf_counter()
    out = ckks.decrypt_decode(rot)
    first["decrypt_decode"] = time.perf_counter() - t1
    err = float(np.max(np.abs(out - np.roll(z * z, -1))))
    if not err <= tol:
        raise AssertionError(f"CKKS n={n}: max abs error {err:.3e} > {tol}")

    warm["encrypt"] = _timed(lambda: ckks.encrypt(pt, sc), iters)
    warm["multiply_relin"] = _timed(lambda: ckks.multiply_relin(ct, ct), iters)
    warm["rescale"] = _timed(lambda: ckks.rescale(m), iters)
    warm["rotate"] = _timed(lambda: ckks.rotate(r, 1), iters)
    t1 = time.perf_counter()
    for _ in range(iters):
        ckks.decrypt_decode(rot)
    warm["decrypt_decode"] = (time.perf_counter() - t1) / iters

    rot_prog = ckks._jits[("galois", g)].lower(r, ckks.galois_key(g)).compile()
    ma = rot_prog.memory_analysis()
    mem = None if ma is None else {
        k: getattr(ma, k) for k in ("argument_size_in_bytes",
                                    "output_size_in_bytes",
                                    "temp_size_in_bytes",
                                    "generated_code_size_in_bytes")}
    dec_key = ("decrypt64", rot.size, rot.level)
    dec_text = ckks._jits[dec_key].lower(
        [c.data for c in rot.c], ckks.sk.s_ntt[:rot.level + 1]
    ).compile().as_text()
    res = {"n": n, "limbs": len(params.moduli) + 1, "max_abs_err": err,
           "tol": tol, "setup_keygen_s": setup_s,
           "first_call_s": first, "warm_ms": {k: v * 1e3 for k, v in
                                              warm.items()},
           "rotate_memory_analysis": mem,
           "rotate_hlo": hlo_findings(rot_prog.as_text()),
           "decrypt_float_dots": hlo_findings(dec_text)["float_dots"],
           "peak_bytes_in_use": _peak_bytes()}
    log(f"[ckks] {json.dumps(res)}")
    return res


def phase_bench(ckks) -> dict:
    """Phase 3: bench.py's own measurement and correctness check, on the
    context that phase 5a reuses (keys and rotation program built once)."""
    import bench
    res = bench.rotation_bench(ckks)
    log(f"[bench] {json.dumps(res)}")
    return res


def phase_bgv(n: int, levels: int, q_bits: int, t_bits: int) -> dict:
    """Phase 4: BGV encrypted dot product, exact mod t."""
    from rfhe_tpu.fhe import BgvContext, BgvParams
    from rfhe_tpu.models.dotprod import dot_product_bgv

    t0 = time.perf_counter()
    params = BgvParams.make(n=n, levels=levels, q_bits=q_bits, t_bits=t_bits)
    bgv = BgvContext(params, seed=11)
    rng = np.random.default_rng(1)
    m1 = rng.integers(0, bgv.t, (2, n // 2), dtype=np.uint32)
    m2 = rng.integers(0, bgv.t, (2, n // 2), dtype=np.uint32)
    ct_x = bgv.encrypt(bgv.encode(m1))
    ct_y = bgv.encrypt(bgv.encode(m2))
    out = _ready(dot_product_bgv(bgv, ct_x, ct_y))
    cold_s = time.perf_counter() - t0
    got = bgv.decrypt_decode(out)
    expect = int((m1.astype(object) * m2.astype(object)).sum()) % bgv.t
    if not (got == expect).all():
        raise AssertionError(f"BGV dot product n={n} is not exact mod t")
    warm_s = _timed(lambda: dot_product_bgv(bgv, ct_x, ct_y), 3)
    res = {"n": n, "limbs": len(params.moduli), "t": bgv.t,
           "cold_s": cold_s, "warm_ms": warm_s * 1e3, "exact": True,
           "peak_bytes_in_use": _peak_bytes()}
    log(f"[bgv] {json.dumps(res)}")
    return res


def phase_protected(ckks) -> dict:
    """Phase 5a: a clean protected rotation is silent and bit-identical to
    the plain one."""
    import jax.numpy as jnp
    from rfhe_tpu.fhe.protected import ProtectedCkks

    n = ckks.params.n
    z = np.random.default_rng(0).uniform(-1, 1, n // 2) + 0j
    ct = ckks.encrypt(*ckks.encode(z))
    prot = ProtectedCkks(ckks)
    out, flags = prot.rotate(ct, 1)
    fired = [k for k, v in flags.items() if not bool(jnp.all(v))]
    if fired:
        raise AssertionError(f"clean protected rotate fired {fired}")
    ref = ckks.rotate(ct, 1)
    for a, b in zip(out.c, ref.c):
        if not bool(jnp.array_equal(a.data, b.data)):
            raise AssertionError("protected rotate != CkksContext.rotate")
    res = {"n": n, "limbs": len(ckks.params.moduli) + 1,
           "clean_flags": sorted(flags)}
    log(f"[protected] {json.dumps(res)}")
    return res


def phase_campaign(n: int, levels: int, trials: int) -> dict:
    """Phase 5b: the flip campaign detects every changing compute-stage
    flip, none at ks_out, and drops no injection (check_row)."""
    from rfhe_tpu.faults import evaluator_campaign

    t0 = time.perf_counter()
    rows = evaluator_campaign.run(n=n, levels=levels, trials=trials,
                                  do_check=True)
    res = {"n": n, "levels": levels, "campaign_s": time.perf_counter() - t0,
           "campaign": [{k: r[k] for k in ("op", "stage", "trials",
                                           "changed", "detected", "missed")}
                        for r in rows]}
    log(f"[campaign] {json.dumps(res)}")
    return res


def phase_multichip(devices, ntt_shape=MULTI_NTT, ckks_shape=None) -> dict:
    """Four-card path: the production sharded NTT over a 4-way `fft` mesh
    (fwd/inv bit-exact vs the single-card plan, NttGuard clean) and the
    limb-sharded CKKS evaluator (multiply_relin + rescale + rotate
    bit-identical to one card)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from rfhe_tpu.fhe import CkksContext, CkksParams
    from rfhe_tpu.ops.ntt_mxu import MxuNttPlan
    from rfhe_tpu.parallel.mesh import shard_ciphertext
    from rfhe_tpu.protect.ntt_guard import NttGuard
    from rfhe_tpu.transform.mxu_sharded import (
        mxu_intt_sharded, mxu_ntt_sharded, mxu_ntt_sharded_protected)
    from rfhe_tpu.utils.jitcache import hoisted_jit

    ckks_shape = ckks_shape or MULTI_CKKS
    D = len(devices)
    res = {"devices": D}

    n, levels, q0, sb = ntt_shape
    primes = _ntt_chain(n, levels, q0, sb)
    plan = MxuNttPlan.make(n, primes)
    mesh = Mesh(np.array(devices), ("fft",))
    x = jnp.asarray(_adversarial(primes, n)[0])
    single_fwd = hoisted_jit(plan.fwd)
    y_ref = _ready(single_fwd(x))
    fwd = hoisted_jit(lambda v: mxu_ntt_sharded(v, plan, mesh))
    inv = hoisted_jit(lambda v: mxu_intt_sharded(v, plan, mesh))
    y, fwd_first_s = _first(lambda: fwd(x))
    if not bool(jnp.array_equal(y, y_ref)):
        raise AssertionError("sharded NTT fwd != single-card MxuNttPlan")
    xr, inv_first_s = _first(lambda: inv(y))
    if not bool(jnp.array_equal(xr, x)):
        raise AssertionError("sharded NTT inv(fwd(x)) != x")
    if not bool(jnp.array_equal(hoisted_jit(plan.inv)(y_ref), xr)):
        raise AssertionError("sharded NTT inv != single-card MxuNttPlan")
    guard = NttGuard.make(plan)
    gres = _ready(hoisted_jit(
        lambda v: mxu_ntt_sharded_protected(v, plan, guard, mesh))(x))
    if not bool(jnp.all(gres.ok)):
        raise AssertionError("sharded NttGuard fired on a clean pass")
    if not bool(jnp.array_equal(gres.y, y_ref)):
        raise AssertionError("protected sharded NTT != single-card plan")
    y_dev = sorted(d.id for d in y.sharding.device_set)
    res["ntt"] = {"n": n, "limbs": len(primes), "fwd_first_s": fwd_first_s,
                  "inv_first_s": inv_first_s, "output_devices": y_dev,
                  "fwd_us": _timed(lambda: fwd(x), 10) * 1e6,
                  "single_fwd_us": _timed(lambda: single_fwd(x), 10) * 1e6}

    params = CkksParams.make(**ckks_shape)
    ckks = CkksContext(params, seed=7)
    cn = ckks_shape["n"]
    rng = np.random.default_rng(2)
    z = rng.uniform(-1, 1, cn // 2) + 1j * rng.uniform(-1, 1, cn // 2)
    ct = ckks.encrypt(*ckks.encode(z))

    def ops(c):
        return ckks.rotate(ckks.rescale(ckks.multiply_relin(c, c)), 1)

    ref = _ready(ops(ct))
    lmesh = Mesh(np.array(devices), ("limb",))
    cts = shard_ciphertext(ct, lmesh)
    out, first_s = _first(lambda: ops(cts))
    for a, b in zip(out.c, ref.c):
        if not bool(jnp.array_equal(a.data, b.data)):
            raise AssertionError("limb-sharded CKKS != single-card CKKS")
    in_dev = sorted(d.id for d in cts.c[0].data.sharding.device_set)
    out_dev = sorted(d.id for d in out.c[0].data.sharding.device_set)
    if len(in_dev) != D:
        raise AssertionError(f"ciphertext not spread over {D} devices")
    res["ckks"] = {"n": cn, "limbs": len(params.moduli) + 1,
                   "input_devices": in_dev, "output_devices": out_dev,
                   "output_sharding": str(out.c[0].data.sharding),
                   "first_s": first_s,
                   "sharded_ms": _timed(lambda: ops(cts), 3) * 1e3,
                   "single_ms": _timed(lambda: ops(ct), 3) * 1e3}
    log(f"[multichip] {json.dumps(res)}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-GPU sharded path")
    args = ap.parse_args(argv)

    from rfhe_tpu.utils.compilecache import enable_compilation_cache
    enable_compilation_cache()
    from rfhe_tpu.bench import device

    t_start = time.perf_counter()
    need = 4 if args.multichip else 1
    info = phase_device()
    if info["count"] < need:
        raise RuntimeError(f"needs {need} GPUs, found {info['count']}")
    gpu = device.gpu_name_and_power_limit()
    log(f"[device] nvidia-smi: {gpu}")

    import jax
    import bench
    if args.multichip:
        phase_multichip(jax.devices()[:4])
    else:
        # The flip campaign is compile-bound (XLA compiles without the
        # GIL) and times nothing, so it runs beside the other phases in
        # this process; every time and peak memory printed includes its
        # load.
        log("[device] concurrent: campaign (background thread)")
        with ThreadPoolExecutor(max_workers=1) as pool:
            campaign = pool.submit(phase_campaign, **CAMPAIGN)
            hbm = device.peaks(info["kind"])["hbm_bytes_per_s"]
            for shape in NTT_SHAPES:
                phase_ntt(*shape, oracle_limbs=1 if shape[0] <= 4096 else 0,
                          hbm_bytes_per_s=hbm)
            phase_ckks(**CKKS_NORTHSTAR)
            ckks = bench.headline_context()
            phase_bench(ckks)
            phase_protected(ckks)
            phase_bgv(**BGV_SHAPE)
            campaign.result()               # re-raises a failed campaign
    log(f"[done] wall_s={time.perf_counter() - t_start:.1f}")
    log(f"[device] {gpu}")
    print(result_line(info), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
