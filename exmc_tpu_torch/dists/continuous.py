"""Univariate continuous distributions: the three that eight schools and
the README quickstart use (``exmc_tpu/dists/continuous.py:18,52,226``).
Every scale parameter is floored at 1e-30."""

import math

import torch

from exmc_tpu_torch import math as xm
from exmc_tpu_torch.dists.base import Distribution, register


class Normal(Distribution):
    name = "normal"

    def logpdf(self, x, params):
        mu, sigma = params["mu"], xm.floor_scale(params["sigma"])
        z = (x - mu) / sigma
        return -0.5 * z * z - torch.log(sigma) - xm.LOG_SQRT_2PI


class HalfNormal(Distribution):
    name = "half_normal"

    def logpdf(self, x, params):
        sigma = xm.floor_scale(params["sigma"])
        z = x / sigma
        return 0.5 * math.log(2.0 / math.pi) - torch.log(sigma) - 0.5 * z * z

    def default_transform(self, params):
        return "softplus"


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
HALF_CAUCHY = register(HalfCauchy())
