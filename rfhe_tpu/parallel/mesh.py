"""Device mesh construction + jax.distributed multi-host init.

Axis conventions across the framework:
  "limb"  RNS residue channels (DP analog; CUDA batch axis in the reference)
  "fft"   the four-step t1 axis (SP analog; all_to_all transposes between devices)
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def make_mesh(n_devices: Optional[int] = None, axis: str = "fft"):
    import jax
    from jax.sharding import Mesh
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def make_mesh_2d(limb: int, fft: int, axes=("limb", "fft")):
    import jax
    from jax.sharding import Mesh
    devs = jax.devices()
    assert limb * fft <= len(devs), f"need {limb * fft} devices"
    return Mesh(np.array(devs[:limb * fft]).reshape(limb, fft), axes)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed for a multi-process run.  Pass the
    coordinator address (e.g. "localhost:<port>"), process count and id:
    nothing in a plain GPU host tells JAX of a cluster."""
    import jax
    if coordinator_address is None:
        jax.distributed.initialize()
    else:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)


def shard_ciphertext(ct, mesh, limb_axis: str = "limb"):
    """Place a Ciphertext's limb axis across the mesh (DP over RNS limbs):
    every evaluator op then runs SPMD under jit — elementwise ops and the
    stacked NTT are embarrassingly parallel over limbs; XLA inserts the few
    collectives the keyswitch mod-down needs."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from rfhe_tpu.fhe.ckks import Ciphertext
    from rfhe_tpu.fhe.rns import RnsPoly
    sh = NamedSharding(mesh, P(limb_axis, None))
    polys = [RnsPoly(jax.device_put(p.data, sh), p.is_ntt) for p in ct.c]
    return Ciphertext(polys, ct.scale, ct.correction)
