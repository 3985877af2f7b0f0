"""L2: four-step NTT transforms (single-device matmul form + mesh-sharded)."""
from .four_step import (  # noqa: F401
    FourStepPlan,
    four_step_ntt,
    four_step_intt,
    four_step_ntt_stages,
)
