"""chip_smoke.py on the CPU: its device gate, its last line, the compile
cache it uses, the peak table, and its phase functions at tiny sizes (the
same functions the script calls at full width on the GPU)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke
from rfhe_tpu.bench import device
from rfhe_tpu.utils import compilecache

REPO = Path(__file__).resolve().parents[1]


def test_device_gate_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.phase_device()
    with pytest.raises(RuntimeError, match="needs a GPU"):
        device.require_gpu()


def test_main_fails_on_cpu_and_prints_no_result(capsys):
    with pytest.raises(RuntimeError):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_result_line_exact_keys():
    info = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = chip_smoke.result_line(info)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def _cache_dir_in_child(env_value):
    """(cache_dir returned, jax's configured dir) in a fresh process, so
    this process's JAX config is left alone."""
    env = dict(os.environ)
    env.pop(compilecache.ENV_VAR, None)
    if env_value is not None:
        env[compilecache.ENV_VAR] = env_value
    code = ("import jax; from rfhe_tpu.utils.compilecache import "
            "enable_compilation_cache as e; d = e(); "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         check=True, capture_output=True, text=True,
                         timeout=120).stdout.split("\n")
    return out[0], out[1]


def test_cache_env_var_honoured_not_overridden(tmp_path):
    want = str(tmp_path / "xla_cache")
    used, configured = _cache_dir_in_child(want)
    assert used == want and configured == want
    assert os.path.isdir(want)


def test_cache_unset_is_fixed_ignored_dir_in_checkout(monkeypatch):
    monkeypatch.delenv(compilecache.ENV_VAR, raising=False)
    first, second = compilecache.cache_dir(), compilecache.cache_dir()
    assert first == second == str(REPO / ".jax_cache")
    used, configured = _cache_dir_in_child(None)
    assert used == configured == first
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split("\n")


def test_peaks_know_h100():
    p = device.peaks("NVIDIA H100 80GB HBM3")
    assert p == {"int8_ops_per_s": 1979e12, "bf16_flops_per_s": 989e12,
                 "hbm_bytes_per_s": 3.35e12}


def test_peaks_refuse_unknown_device():
    with pytest.raises(ValueError, match="no published peaks"):
        device.peaks("cpu")


def test_hlo_findings_counts_kernels_and_float_dots():
    ints = jax.jit(lambda a, b: jnp.matmul(
        a, b, preferred_element_type=jnp.int32) + 1)
    x8 = jnp.ones((8, 8), jnp.int8)
    f = chip_smoke.hlo_findings(ints.lower(x8, x8).compile().as_text())
    assert f["kernels"] >= 1 and f["float_dots"] == 0
    floats = jax.jit(lambda a, b: a @ b)
    xf = jnp.ones((8, 8), jnp.float32)
    g = chip_smoke.hlo_findings(floats.lower(xf, xf).compile().as_text())
    assert g["float_dots"] >= 1


def test_phase_ntt_small():
    res = chip_smoke.phase_ntt(256, 2, 30, 28, oracle_limbs=1, iters=1,
                               hbm_bytes_per_s=3.35e12)
    assert res["bit_exact"] and res["limbs"] == 3
    assert res["hlo_fwd"]["kernels"] >= 1
    assert res["hlo_fwd"]["float_dots"] == res["hlo_inv"]["float_dots"] == 0
    assert res["fwd_over_floor"] > 0


def test_phase_ckks_small():
    res = chip_smoke.phase_ckks(1024, 2, 31, 56, iters=1)
    assert res["max_abs_err"] <= chip_smoke.CKKS_TOL
    assert res["decrypt_float_dots"] == 0
    assert set(res["warm_ms"]) == {"encrypt", "multiply_relin", "rescale",
                                   "rotate", "decrypt_decode"}


def test_phase_bgv_small():
    res = chip_smoke.phase_bgv(256, 2, 30, 16)
    assert res["exact"] and res["limbs"] == 3


def test_phase_bench_small():
    res = chip_smoke.phase_bench(bench.headline_context(512, 3))
    assert res["metric"] == "ckks_rotation_n512_L4_latency"


def test_phase_protected_small():
    res = chip_smoke.phase_protected(bench.headline_context(512, 3))
    assert "ks_core" in res["clean_flags"] and res["limbs"] == 5


def test_phase_campaign_small():
    res = chip_smoke.phase_campaign(256, 2, trials=32)
    rows = {(r["op"], r["stage"]): r for r in res["campaign"]}
    assert len(rows) == 12
    assert all(r["detected"] == 0 for (_, s), r in rows.items()
               if s == "ks_out")


def test_phase_multichip_on_4_cpu_devices():
    devs = jax.devices()[:4]
    assert len(devs) == 4
    res = chip_smoke.phase_multichip(
        devs, ntt_shape=(1024, 2, 30, 28),
        ckks_shape=dict(n=1024, levels=1, q0_bits=31, scale_bits=56))
    assert res["ntt"]["output_devices"] == [d.id for d in devs]
    assert res["ckks"]["input_devices"] == [d.id for d in devs]
    assert np.isfinite(res["ckks"]["sharded_ms"])
