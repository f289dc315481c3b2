"""Discrete distributions, as observation-only likelihoods
(``exmc_tpu/dists/discrete.py:14``): NUTS samples no discrete free RV.
Poisson, Binomial and the rest wait (ROADMAP §1)."""

import torch

from exmc_tpu_torch.dists.base import Distribution, register


class Bernoulli(Distribution):
    """Bernoulli(p), or Bernoulli(logits) through the stable log-sigmoid
    ``y * eta - logaddexp(0, eta)``: in float32, clipping p at 1 - 1e-12
    rounds to 1.0 and ``log1p(-p)`` turns -inf at moderate logits."""

    name = "bernoulli"

    def logpdf(self, y, params):
        if "logits" in params:
            eta = params["logits"]
            return y * eta - torch.logaddexp(torch.zeros_like(eta), eta)
        p = torch.as_tensor(params["p"])
        eps = torch.finfo(torch.promote_types(p.dtype, torch.float32)).eps
        p = torch.clamp(p, eps, 1.0 - eps)
        return y * torch.log(p) + (1.0 - y) * torch.log1p(-p)

    def default_transform(self, params):
        return "logit"


BERNOULLI = register(Bernoulli())
