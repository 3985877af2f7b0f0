"""L1 device ops: u32 modular arithmetic, int8-digit modular matmul, NTTs
(elementwise butterfly paths + the four-step matmul path), RNS base
conversion."""
from . import u32  # noqa: F401
from .u32 import (  # noqa: F401
    mul32_parts,
    mulhi32,
    add_mod,
    sub_mod,
    neg_mod,
    mont_mul,
    to_mont,
    from_mont,
    mul_mod,
    mul_mod_shoup,
    pow_mod,
)
from .matmul_mod import matmul_mod, DigitPlan  # noqa: F401
from .ntt import (  # noqa: F401
    NttPlan,
    StackedNttPlan,
    ntt,
    intt,
    negacyclic_ntt,
    negacyclic_intt,
    pointwise_mul,
    poly_mul_negacyclic,
)
from .baseconv import base_conv, BaseConvPlan  # noqa: F401
