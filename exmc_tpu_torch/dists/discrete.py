"""Discrete distributions, as observation-only likelihoods
(``exmc_tpu/dists/discrete.py``): NUTS samples no discrete free RV.
Integer-coded values arrive as float32 tensors."""

import torch

from exmc_tpu_torch import math as xm
from exmc_tpu_torch.dists import _sampling as rs
from exmc_tpu_torch.dists.base import Distribution, register


def _clip_p(p, hi=None):
    """p clipped to [eps, 1 - eps] (or [eps, hi]) with the float32 eps."""
    p = torch.as_tensor(p)
    eps = torch.finfo(torch.promote_types(p.dtype, torch.float32)).eps
    return torch.clamp(p, eps, 1.0 - eps if hi is None else hi)


def _logsigmoid_pair(eta):
    """log(1 + e^eta) as logaddexp(0, eta)."""
    return torch.logaddexp(torch.zeros_like(eta), eta)


def _take_last(logp, y):
    """logp[..., y] with the batch axes of ``logp[..., 0]`` and ``y``
    broadcast against each other."""
    shape = torch.broadcast_shapes(logp.shape[:-1], y.shape)
    idx = y.expand(shape).long().unsqueeze(-1)
    return torch.gather(logp.expand(shape + logp.shape[-1:]), -1, idx)[..., 0]


class Bernoulli(Distribution):
    """Bernoulli(p), or Bernoulli(logits) through the stable log-sigmoid
    ``y * eta - logaddexp(0, eta)``: in float32, clipping p at 1 - 1e-12
    rounds to 1.0 and ``log1p(-p)`` turns -inf at moderate logits."""

    name = "bernoulli"

    def logpdf(self, y, params):
        if "logits" in params:
            eta = params["logits"]
            return y * eta - _logsigmoid_pair(eta)
        p = _clip_p(params["p"])
        return y * torch.log(p) + (1.0 - y) * torch.log1p(-p)

    def support(self, params):
        return "unit"

    def default_transform(self, params):
        return "logit"

    def sample(self, params, shape, generator):
        p = (torch.sigmoid(rs.as_tensor(params["logits"], generator))
             if "logits" in params else rs.as_tensor(params["p"], generator))
        return (rs.rand(rs.full_shape(shape, p), generator) < p).to(p.dtype)


class Poisson(Distribution):
    """Poisson(mu)."""

    name = "poisson"

    def logpdf(self, y, params):
        mu = xm.floor_scale(params["mu"])
        return y * torch.log(mu) - mu - xm.lgamma(y + 1.0)

    def support(self, params):
        return "positive"

    def default_transform(self, params):
        return "log"

    def sample(self, params, shape, generator):
        return rs.poisson(params["mu"], shape, generator)


class Binomial(Distribution):
    """Binomial(n, p), or Binomial(n, logits) through the stable
    log-sigmoid path."""

    name = "binomial"

    def logpdf(self, y, params):
        n = params["n"]
        comb = xm.lgamma(n + 1.0) - xm.lgamma(y + 1.0) - xm.lgamma(n - y + 1.0)
        if "logits" in params:
            eta = params["logits"]
            return comb + y * eta - n * _logsigmoid_pair(eta)
        p = _clip_p(params["p"])
        return comb + y * torch.log(p) + (n - y) * torch.log1p(-p)

    def support(self, params):
        return "unit"

    def default_transform(self, params):
        return "logit"

    def sample(self, params, shape, generator):
        p = (torch.sigmoid(rs.as_tensor(params["logits"], generator))
             if "logits" in params else params["p"])
        return rs.binomial(params["n"], p, shape, generator)


class NegativeBinomial(Distribution):
    """NegativeBinomial(mu, alpha), the mean/overdispersion form
    (alpha -> inf recovers Poisson(mu))."""

    name = "negative_binomial"

    def logpdf(self, y, params):
        mu = xm.floor_scale(params["mu"])
        alpha = xm.floor_scale(params["alpha"])
        comb = xm.lgamma(y + alpha) - xm.lgamma(alpha) - xm.lgamma(y + 1.0)
        return (comb + alpha * (torch.log(alpha) - torch.log(alpha + mu))
                + y * (torch.log(mu) - torch.log(alpha + mu)))

    def support(self, params):
        return "positive"

    def default_transform(self, params):
        return "log"

    def sample(self, params, shape, generator):
        mu, alpha = params["mu"], params["alpha"]
        lam = rs.gamma(alpha, shape, generator) * (mu / alpha)
        return rs.poisson(lam, (), generator)


class Categorical(Distribution):
    """Categorical(p) over {0..K-1} along the last axis of ``p`` (or
    ``logits``); y is integer-coded."""

    name = "categorical"
    param_event_dims = {"p": 1, "logits": 1}

    def logpdf(self, y, params):
        if "logits" in params:
            logp = torch.log_softmax(params["logits"], dim=-1)
        else:
            logp = torch.log(_clip_p(params["p"], hi=1.0))
        return _take_last(logp, y)

    def support(self, params):
        return "simplex"

    def default_transform(self, params):
        return "stick_breaking"

    def sample(self, params, shape, generator):
        logits = (params["logits"] if "logits" in params else
                  torch.log(torch.clamp(rs.as_tensor(params["p"], generator),
                                        1e-30, 1.0)))
        return rs.categorical(logits, shape, generator)


class BetaBinomial(Distribution):
    """BetaBinomial(n, alpha, beta): C(n,k) B(k+a, n-k+b) / B(a,b)."""

    name = "beta_binomial"

    def logpdf(self, y, params):
        n = params["n"]
        a = xm.floor_scale(params["alpha"])
        b = xm.floor_scale(params["beta"])
        comb = xm.lgamma(n + 1.0) - xm.lgamma(y + 1.0) - xm.lgamma(n - y + 1.0)
        return comb + xm.lbeta(y + a, n - y + b) - xm.lbeta(a, b)

    def sample(self, params, shape, generator):
        shape = rs.full_shape(shape, params["alpha"], params["beta"], params["n"])
        ga = rs.gamma(params["alpha"], shape, generator)
        gb = rs.gamma(params["beta"], shape, generator)
        return rs.binomial(params["n"], ga / (ga + gb), shape, generator)


class OrderedLogistic(Distribution):
    """OrderedLogistic(eta, cutpoints): y in 0..K-1 with K-1 ordered
    cutpoints along the last axis of ``cutpoints``;
    P(y = k) = sigmoid(eta - c_k) - sigmoid(eta - c_{k+1}), the ladder
    padded by -inf/+inf, in log space."""

    name = "ordered_logistic"
    param_event_dims = {"cutpoints": 1}

    def logpdf(self, y, params):
        eta, c = params["eta"], params["cutpoints"]
        eta = eta.expand(torch.broadcast_shapes(eta.shape, y.shape))
        diff = eta[..., None] - c
        la_all = -_logsigmoid_pair(-diff)                      # (..., K-1)
        la = torch.cat([torch.zeros_like(la_all[..., :1]), la_all], dim=-1)
        lb = torch.cat([la_all, torch.full_like(la_all[..., :1], -torch.inf)],
                       dim=-1)
        log_p = la + torch.log1p(-torch.exp(torch.clamp_max(lb - la, -1e-7)))
        return _take_last(log_p, y)

    def sample(self, params, shape, generator):
        eta = rs.as_tensor(params["eta"], generator)
        c = rs.as_tensor(params["cutpoints"], generator)
        hi = torch.sigmoid(eta[..., None] - c)
        sig = torch.cat([torch.ones_like(hi[..., :1]), hi,
                         torch.zeros_like(hi[..., :1])], dim=-1)
        p = sig[..., :-1] - sig[..., 1:]
        return rs.categorical(torch.log(torch.clamp(p, 1e-30, 1.0)), shape,
                              generator)


BERNOULLI = register(Bernoulli())
POISSON = register(Poisson())
BINOMIAL = register(Binomial())
NEGATIVE_BINOMIAL = register(NegativeBinomial())
CATEGORICAL = register(Categorical())
BETA_BINOMIAL = register(BetaBinomial())
ORDERED_LOGISTIC = register(OrderedLogistic())
