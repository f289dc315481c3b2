"""The distribution library: the JAX package's 32 registered
distributions under its names, plus ``Custom``."""

from exmc_tpu_torch.dists.base import Distribution, all_dists, get, register
from exmc_tpu_torch.dists.continuous import (
    NORMAL as Normal,
    FLAT as Flat,
    HALF_NORMAL as HalfNormal,
    EXPONENTIAL as Exponential,
    GAMMA as Gamma,
    BETA as Beta,
    UNIFORM01 as Uniform01,
    UNIFORM as Uniform,
    STUDENT_T as StudentT,
    CAUCHY as Cauchy,
    HALF_CAUCHY as HalfCauchy,
    LOGNORMAL as LogNormal,
    LAPLACE as Laplace,
    TRUNCATED_NORMAL as TruncatedNormal,
    WEIBULL as Weibull,
    INVERSE_GAMMA as InverseGamma,
    GUMBEL as Gumbel,
)
from exmc_tpu_torch.dists.discrete import (
    BERNOULLI as Bernoulli,
    POISSON as Poisson,
    BINOMIAL as Binomial,
    NEGATIVE_BINOMIAL as NegativeBinomial,
    CATEGORICAL as Categorical,
    BETA_BINOMIAL as BetaBinomial,
    ORDERED_LOGISTIC as OrderedLogistic,
)
from exmc_tpu_torch.dists.multivariate import (
    MV_NORMAL as MvNormal,
    DIRICHLET as Dirichlet,
    LKJ_CHOLESKY as LKJCholesky,
    MULTINOMIAL as Multinomial,
    ZERO_SUM_NORMAL as ZeroSumNormal,
)
from exmc_tpu_torch.dists.timeseries import (
    GAUSSIAN_RANDOM_WALK as GaussianRandomWalk,
)
from exmc_tpu_torch.dists.composite import (
    MIXTURE as Mixture,
    CENSORED as Censored,
    Custom,
)

__all__ = [
    "Distribution", "get", "register", "all_dists",
    "Normal", "Flat", "HalfNormal", "Exponential", "Gamma", "Beta",
    "Uniform01", "Uniform", "StudentT", "Cauchy", "HalfCauchy", "LogNormal",
    "Laplace", "TruncatedNormal", "Weibull", "InverseGamma", "Gumbel",
    "Bernoulli", "Binomial", "NegativeBinomial", "Categorical",
    "BetaBinomial", "OrderedLogistic", "Poisson",
    "MvNormal", "Dirichlet", "LKJCholesky", "Multinomial", "ZeroSumNormal",
    "GaussianRandomWalk", "Mixture", "Censored", "Custom",
]
