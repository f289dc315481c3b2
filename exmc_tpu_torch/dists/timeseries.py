"""GaussianRandomWalk (``exmc_tpu/dists/timeseries.py:16``)."""

import torch

from exmc_tpu_torch import math as xm
from exmc_tpu_torch.dists import _sampling as rs
from exmc_tpu_torch.dists.base import Distribution, register


class GaussianRandomWalk(Distribution):
    """GaussianRandomWalk(sigma) over a length-T vector:
    x[0] ~ Normal(0, sigma), x[t] ~ Normal(x[t-1], sigma).

    ``x`` is (C, T): the increments are taken along the last (event)
    axis, never the chain axis, and the result is one value per chain."""

    name = "gaussian_random_walk"

    def logpdf(self, x, params):
        sigma = xm.floor_scale(params["sigma"])
        increments = torch.cat([x[..., :1], torch.diff(x, dim=-1)], dim=-1)
        z = increments / sigma
        return torch.sum(-0.5 * z * z - torch.log(sigma) - xm.LOG_SQRT_2PI,
                         dim=-1)

    def sample(self, params, shape, generator):
        shape = tuple(shape) if shape else (int(params["steps"]),)
        return torch.cumsum(params["sigma"] * rs.randn(shape, generator), dim=-1)


GAUSSIAN_RANDOM_WALK = register(GaussianRandomWalk())
