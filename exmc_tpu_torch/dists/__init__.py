"""The ported distributions (3 of the JAX package's 34; ROADMAP §1)."""

from exmc_tpu_torch.dists.base import Distribution, get, register
from exmc_tpu_torch.dists.continuous import (
    NORMAL as Normal,
    HALF_NORMAL as HalfNormal,
    HALF_CAUCHY as HalfCauchy,
)

__all__ = [
    "Distribution",
    "get",
    "register",
    "Normal",
    "HalfNormal",
    "HalfCauchy",
]
