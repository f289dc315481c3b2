"""Particle marginal Metropolis-Hastings (``exmc_tpu/particle/pmcmc.py``).

Random-walk MH on the parameter vector where the intractable likelihood
is the particle filter's UNBIASED estimate (Andrieu, Doucet &
Holenstein 2010: the chain targets the exact posterior despite the
noise). The chains advance together: every iteration runs one filter
per chain, all of them as one batch (``filter.run_filter``).
"""

import torch

from exmc_tpu_torch.config import default_dtype


def pmcmc(log_marginal_fn, log_prior_fn, theta0, num_samples, generator,
          step_scale=0.2, num_chains=1, draws=None):
    """Run PMMH on the generator's device.

    ``log_marginal_fn(generator, theta) -> (C,)`` for a batch of points
    theta (C, d) (e.g. from ``filter.make_log_marginal_fn``, indexing
    ``theta[..., i]``); ``log_prior_fn(theta) -> (C,)``; theta0 (d,) is
    every chain's start. ``draws`` injects the proposal normals
    ``"z"`` (num_samples, C, d) and the uniforms ``"u"``
    (num_samples, C). Returns (thetas (C, num_samples, d),
    accept_rate (C,)).

    The JAX package skips a chain's filter (``lax.cond``) when the prior
    rejects its proposal; here every chain's filter runs and a rejected
    proposal's estimate is masked to -inf."""
    dev = generator.device
    dtype = default_dtype()
    theta = torch.as_tensor(theta0, dtype=dtype, device=dev).reshape(1, -1)
    d = theta.shape[-1]
    theta = theta.expand(num_chains, d).contiguous()
    scale = torch.broadcast_to(torch.as_tensor(step_scale, dtype=dtype, device=dev), (d,))
    ll = log_marginal_fn(generator, theta) + log_prior_fn(theta)
    acc = torch.zeros(num_chains, dtype=dtype, device=dev)
    out = []
    for i in range(num_samples):
        if draws is None:
            z = torch.randn(num_chains, d, generator=generator, dtype=dtype, device=dev)
            u = torch.rand(num_chains, generator=generator, dtype=dtype, device=dev)
        else:
            z = torch.as_tensor(draws["z"][i], dtype=dtype, device=dev)
            u = torch.as_tensor(draws["u"][i], dtype=dtype, device=dev)
        prop = theta + scale * z
        lp_prior = log_prior_fn(prop)
        ll_f = log_marginal_fn(generator, prop)
        ll_prop = torch.where(torch.isfinite(lp_prior), ll_f + lp_prior,
                              torch.full_like(lp_prior, -torch.inf))
        # U(1e-20, 1), as the JAX package draws it
        log_u = torch.log(1e-20 + (1.0 - 1e-20) * u)
        accept = log_u < (ll_prop - ll)
        theta = torch.where(accept.unsqueeze(-1), prop, theta)
        ll = torch.where(accept, ll_prop, ll)
        acc = acc + accept.to(dtype)
        out.append(theta)
    return torch.stack(out, dim=1), acc / num_samples
