"""The ported distributions (7 of the JAX package's 34; ROADMAP §1),
under the JAX package's names."""

from exmc_tpu_torch.dists.base import Distribution, get, register
from exmc_tpu_torch.dists.continuous import (
    NORMAL as Normal,
    HALF_NORMAL as HalfNormal,
    EXPONENTIAL as Exponential,
    STUDENT_T as StudentT,
    HALF_CAUCHY as HalfCauchy,
)
from exmc_tpu_torch.dists.discrete import BERNOULLI as Bernoulli
from exmc_tpu_torch.dists.timeseries import (
    GAUSSIAN_RANDOM_WALK as GaussianRandomWalk,
)

__all__ = [
    "Distribution",
    "get",
    "register",
    "Normal",
    "HalfNormal",
    "Exponential",
    "StudentT",
    "HalfCauchy",
    "Bernoulli",
    "GaussianRandomWalk",
]
