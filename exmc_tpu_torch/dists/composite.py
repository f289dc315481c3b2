"""Composite distributions (``exmc_tpu/dists/composite.py``): Mixture,
Censored and Custom."""

import inspect

import torch

from exmc_tpu_torch import math as xm
from exmc_tpu_torch.dists import _sampling as rs
from exmc_tpu_torch.dists.base import Distribution, get as get_dist, register


class Mixture(Distribution):
    """Finite mixture: logsumexp_k(log w_k + logpdf_k(x)).

    params: {"components": [dist, ...], "params": [params_k, ...],
    "weights": (..., K)}; ``weights`` may be a reference (e.g. to a
    Dirichlet RV)."""

    name = "mixture"
    param_event_dims = {"weights": 1}

    def logpdf(self, x, params):
        components = [get_dist(c) for c in params["components"]]
        log_w = torch.log(params["weights"])
        lps = [d.logpdf(x, p) + log_w[..., k]
               for k, (d, p) in enumerate(zip(components, params["params"]))]
        return torch.logsumexp(torch.stack(torch.broadcast_tensors(*lps)), dim=0)

    def support(self, params):
        return get_dist(params["components"][0]).support(params["params"][0])

    def default_transform(self, params):
        return get_dist(params["components"][0]).default_transform(params["params"][0])

    def sample(self, params, shape, generator):
        components = [get_dist(c) for c in params["components"]]
        w = rs.as_tensor(params["weights"], generator)
        idx = rs.categorical(torch.log(w), shape, generator).long()
        draws = torch.stack(torch.broadcast_tensors(*[
            rs.as_tensor(d.sample(p, shape, generator), generator)
            for d, p in zip(components, params["params"])]))
        return torch.gather(draws, 0, idx.expand(draws.shape[1:])[None])[0]


class Censored(Distribution):
    """Censored observation likelihoods:

    right at c:  log SF(c);  left at c:  log CDF(c);
    interval:    log(CDF(b) - CDF(a)), value = {"lower", "upper"}.

    Uses the base dist's ``log_survival``/``log_cdf`` when it has one
    (Weibull), else the Normal's, through ``log_ndtr``."""

    name = "censored"

    def log_likelihood(self, censor_type, value, dist, params):
        dist = get_dist(dist)
        if censor_type == "right":
            if hasattr(dist, "log_survival"):
                return dist.log_survival(value, params)
            return xm.log_normal_sf(self._z(value, params))
        if censor_type == "left":
            if hasattr(dist, "log_cdf"):
                return dist.log_cdf(value, params)
            return xm.log_normal_cdf(self._z(value, params))
        if censor_type == "interval":
            lower, upper = value["lower"], value["upper"]
            if hasattr(dist, "log_cdf"):
                lc_hi = dist.log_cdf(upper, params)
                lc_lo = dist.log_cdf(lower, params)
                return lc_hi + xm.log1mexp(lc_lo - lc_hi)
            mu, sigma = params["mu"], xm.floor_scale(params["sigma"])
            return torch.log(xm.normal_cdf((upper - mu) / sigma)
                             - xm.normal_cdf((lower - mu) / sigma))
        raise ValueError(f"unknown censor type: {censor_type!r}")

    @staticmethod
    def _z(value, params):
        return (value - params.get("mu", 0.0)) / xm.floor_scale(params["sigma"])


class Custom(Distribution):
    """User-defined density, given as a torch callable::

        Custom(logpdf_fn=lambda x, params, data=None: ...,
               support="real", transform=None, sample_fn=None,
               align=True, counters=None)

    ``logpdf_fn`` receives batched torch tensors with the leading chain
    axis (see ``base.py``) and returns the elementwise log-density; it
    may take a ``data`` keyword to receive the data registered with
    ``Builder.data``. ``align=False`` passes the value and parameters
    without the batch-axis alignment, each as it is with its chain axis
    (1 for constants) or 0-d, for a density that reads whole arrays
    (``hmm.hmm_dist``). ``sample_fn(params, shape, generator)`` is
    optional. ``counters`` is an object with ``name``, ``reset()`` and
    ``read()`` that the density updates, such as a Laplace marginal's
    ``counters`` (``marginal.LaplaceCounters``): the compiled model lists
    it (``CompiledModel.counters``) and a NUTS run reports its ``read()``
    under its ``name`` in its stats (``stats["laplace"]``). A JAX
    callable cannot be carried over from the JAX package: write the
    density in torch."""

    name = "custom"

    def __init__(self, logpdf_fn, support="real", transform=None, sample_fn=None,
                 align=True, counters=None):
        self.logpdf_fn = logpdf_fn
        self.align = align
        self.counters = counters
        self._support = support
        self._transform = transform
        self.sample_fn = sample_fn
        self._wants_data = "data" in inspect.signature(logpdf_fn).parameters

    def logpdf(self, x, params):
        data = params.get("__data__")
        user_params = {k: v for k, v in params.items() if k != "__data__"}
        if self._wants_data:
            return self.logpdf_fn(x, user_params, data=data)
        return self.logpdf_fn(x, user_params)

    def support(self, params):
        return self._support

    def default_transform(self, params):
        return self._transform

    def sample(self, params, shape, generator):
        if self.sample_fn is None:
            raise NotImplementedError("Custom dist has no sample_fn")
        return self.sample_fn(params, shape, generator)


MIXTURE = register(Mixture())
CENSORED = register(Censored())
