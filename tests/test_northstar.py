"""North-star configuration tests (BASELINE.json targets; VERDICT r1 #3):

  1. CKKS multiply+rescale at N = 2^16, L = 16 — the reference's largest
     profiled config class (profile_framewk/src/dotprod_ckks.cpp:96-104
     runs N = 32768 / 21 limbs; draw_rotation.py:59 sweeps to 65536).
  2. BGV encrypted dot product at N = 16384 — the reference's real-GPU
     campaign config (reliability_test/dotprod_test.cu:198-204: N = 16384,
     6 x 50-bit limbs, 20-bit plain modulus).  This framework's chain uses
     10 x 30-bit limbs (same ~300-bit modulus budget): the exact
     int8-digit path favors more narrow limbs over fewer wide ones — see
     PARITY.md "limb width".

These run at full size (minutes of XLA compile on CPU), so they are gated
behind RFHE_RUN_SLOW=1; on the GPU, `python chip_smoke.py` runs both
shapes (BGV at the N its time limit allows; PERF.md).
"""
import os

import numpy as np
import pytest

slow = pytest.mark.skipif(os.environ.get("RFHE_RUN_SLOW") != "1",
                          reason="north-star shapes: set RFHE_RUN_SLOW=1")


@slow
def test_ckks_mult_rescale_n65536_L16():
    from rfhe_tpu.fhe import CkksContext, CkksParams

    n, levels = 65536, 16
    params = CkksParams.make(n=n, levels=levels, q0_bits=31, scale_bits=56)
    assert len(params.moduli) == 2 + 2 * levels    # composite scale pairs
    ckks = CkksContext(params, seed=7)
    rng = np.random.default_rng(0)
    z = rng.uniform(-1, 1, n // 2) + 1j * rng.uniform(-1, 1, n // 2)
    ct = ckks.encrypt(*ckks.encode(z))
    m = ckks.rescale(ckks.multiply(ct, ct))
    assert m.level == ct.level - params.alpha   # composite scale: 2 limbs
    zm = ckks.decrypt_decode(m)
    np.testing.assert_allclose(zm, z * z, atol=1e-6)


@slow
def test_bgv_dotprod_n16384():
    from rfhe_tpu.fhe import BgvContext, BgvParams
    from rfhe_tpu.models.dotprod import dot_product_bgv

    n = 16384
    params = BgvParams.make(n=n, levels=9, q_bits=30, t_bits=20)
    assert sum(q.bit_length() for q in params.moduli) >= 290
    bgv = BgvContext(params, seed=11)
    rng = np.random.default_rng(1)
    m1 = rng.integers(0, bgv.t, (2, n // 2), dtype=np.uint32)
    m2 = rng.integers(0, bgv.t, (2, n // 2), dtype=np.uint32)
    out = dot_product_bgv(bgv, bgv.encrypt(bgv.encode(m1)),
                          bgv.encrypt(bgv.encode(m2)))
    got = bgv.decrypt_decode(out)
    expect = int((m1.astype(object) * m2.astype(object)).sum()) % bgv.t
    assert (got == expect).all()                # exact mod-t dot product
