"""Which device a measurement ran on, and that device's published peaks.

Every benchmark CLI prints `banner()` beside its numbers and calls
`require_gpu()` before it times anything, so a number taken on the CPU is
never reported under a device metric's name.  The library functions the
tests call stay CPU-callable; only the CLIs gate.
"""
from __future__ import annotations

import subprocess

#: Published dense peaks per `device_kind` (NVIDIA H100 Tensor Core GPU data
#: sheet, SXM part, without sparsity; rates assume the 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "int8_ops_per_s": 1979e12,
        "bf16_flops_per_s": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks(device_kind: str) -> dict:
    """Peaks for `device_kind`; an unknown device is an error, not a
    default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind={device_kind!r}; "
            f"known: {sorted(PEAKS)}") from None


def device_info() -> dict:
    """platform / device_kind / count of the default backend, as JAX
    reports them."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def banner() -> str:
    info = device_info()
    return (f"# device: platform={info['platform']} "
            f"device_kind={info['kind']} count={info['count']}")


def require_gpu(count: int = 1) -> dict:
    """Fail unless the default backend is a GPU with at least `count`
    devices.  There is no CPU fallback."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"needs a GPU; JAX found platform={info['platform']} "
            f"({info['kind']}) — refusing to report a device metric")
    if info["count"] < count:
        raise RuntimeError(
            f"needs {count} GPUs; JAX found {info['count']}")
    return info


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi`'s name and power limit of each card, one per line.
    Runs as a child process that never touches JAX; raises if it cannot be
    read."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed no GPU")
    return out


def rehearse_on_cpu(n_devices: int) -> None:
    """Put this process on `n_devices` virtual CPU devices.  Must run before
    JAX initializes a backend; for explicit CPU rehearsals only (output then
    names platform=cpu through `banner()`)."""
    import os
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n_devices}"
        ).strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
