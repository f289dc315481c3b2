"""Univariate continuous distributions: the five that eight schools, the
README quickstart and the seven-model suite use
(``exmc_tpu/dists/continuous.py:18,52,72,186,226``). Every scale
parameter is floored at 1e-30."""

import math

import torch

from exmc_tpu_torch import math as xm
from exmc_tpu_torch.config import default_dtype
from exmc_tpu_torch.dists.base import Distribution, register


def _randn(shape, generator):
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=default_dtype())


class Normal(Distribution):
    name = "normal"

    def logpdf(self, x, params):
        mu, sigma = params["mu"], xm.floor_scale(params["sigma"])
        z = (x - mu) / sigma
        return -0.5 * z * z - torch.log(sigma) - xm.LOG_SQRT_2PI

    def sample(self, params, shape, generator):
        return params["mu"] + params["sigma"] * _randn(shape, generator)


class HalfNormal(Distribution):
    name = "half_normal"

    def logpdf(self, x, params):
        sigma = xm.floor_scale(params["sigma"])
        z = x / sigma
        return 0.5 * math.log(2.0 / math.pi) - torch.log(sigma) - 0.5 * z * z

    def default_transform(self, params):
        return "softplus"

    def sample(self, params, shape, generator):
        return params["sigma"] * torch.abs(_randn(shape, generator))


class Exponential(Distribution):
    """Exponential with rate ``lambda``."""

    name = "exponential"

    def logpdf(self, x, params):
        lam = xm.floor_scale(params["lambda"])
        return torch.log(lam) - lam * x

    def default_transform(self, params):
        return "log"

    def sample(self, params, shape, generator):
        e = torch.empty(shape, device=generator.device, dtype=default_dtype())
        return e.exponential_(generator=generator) / params["lambda"]


class StudentT(Distribution):
    """StudentT(df, loc=0, scale=1); ``df`` may be a sampled value."""

    name = "student_t"

    def logpdf(self, x, params):
        df = params["df"]
        loc = params.get("loc", 0.0)
        scale = params.get("scale")
        if scale is None:
            z, log_scale = x - loc, 0.0
        else:
            scale = xm.floor_scale(scale)
            z, log_scale = (x - loc) / scale, torch.log(scale)
        return (
            xm.lgamma((df + 1.0) / 2.0)
            - xm.lgamma(df / 2.0)
            - 0.5 * torch.log(df * math.pi)
            - log_scale
            - (df + 1.0) / 2.0 * torch.log1p(z * z / df)
        )


class HalfCauchy(Distribution):
    name = "half_cauchy"

    def logpdf(self, x, params):
        scale = xm.floor_scale(params["scale"])
        z = x / scale
        return math.log(2.0 / math.pi) - torch.log(scale) - torch.log1p(z * z)

    def default_transform(self, params):
        return "log"


NORMAL = register(Normal())
HALF_NORMAL = register(HalfNormal())
EXPONENTIAL = register(Exponential())
STUDENT_T = register(StudentT())
HALF_CAUCHY = register(HalfCauchy())
