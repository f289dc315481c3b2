"""SMC^2 (``exmc_tpu/particle/smc2.py``; Chopin, Jacob &
Papaspiliopoulos 2013): sequential Bayesian inference for state-space
models with intractable likelihoods.

N_theta parameter particles each carry an N_x-particle bootstrap
filter; all of them advance as one batch of filters. At each
observation every filter advances one step and its incremental
predictive likelihood reweights the theta cloud; when the theta ESS
collapses, the cloud resamples and rejuvenates with particle-MCMC moves
whose likelihoods come from fresh filters over y_{1:t}. The JAX
package decides that inside the program (``lax.cond``); here the ESS is
read on the host once per time step (``host_syncs`` counts the reads),
as ``smc.py`` reads once per stage, and a rejuvenation's filters run
over exactly y_{1:t}, so no time mask is needed.
"""

import math

import torch

from exmc_tpu_torch.config import default_dtype
from exmc_tpu_torch.particle.filter import _per_particle, run_filter, systematic_resample


def _rows(x, idx, n):
    """Rows of the per-point blocks (B * n, ...) of x, reordered by the
    point indices ``idx`` (B,)."""
    blocks = x.reshape(-1, n, *x.shape[1:])[idx]
    return blocks.reshape(-1, *x.shape[1:])


def smc2(init_fn, step_fn, loglik_fn, prior_sample_fn, log_prior_fn, ys, n_theta, n_x,
         generator, ess_threshold=0.5, rejuvenation_moves=2, pf_ess_threshold=0.5):
    """Run batch SMC^2 over observations ``ys`` on the generator's
    device.

    Model interface as in :func:`particle_filter`, with ``params`` the
    theta rows (one per particle: index them as ``params[..., i]``),
    plus ``prior_sample_fn(generator, n) -> (n, d)`` theta draws and
    ``log_prior_fn(theta (n, d)) -> (n,)``.

    Returns dict with ``thetas (n_theta, d)``, ``log_weights
    (n_theta,)`` (final importance weights: posterior expectations are
    softmax-weighted averages), ``log_evidence`` (log p^(y_{1:T})),
    ``ess_history (T,)``, ``rejuvenations`` (count),
    ``theta_log_marginals`` and ``host_syncs``."""
    dev = generator.device
    dtype = default_dtype()
    ys = torch.as_tensor(ys, dtype=dtype, device=dev)
    thetas = torch.as_tensor(prior_sample_fn(generator, n_theta), dtype=dtype, device=dev)
    d = thetas.shape[1]
    xs = init_fn(generator, n_theta * n_x, _per_particle(thetas, n_x))
    log_ws = torch.zeros(n_theta, n_x, dtype=dtype, device=dev)
    log_mls = torch.zeros(n_theta, dtype=dtype, device=dev)
    log_W = torch.zeros(n_theta, dtype=dtype, device=dev)
    log_Z = torch.zeros((), dtype=dtype, device=dev)
    offset = (torch.arange(n_theta, device=dev) * n_x).unsqueeze(-1)
    plain = torch.arange(n_theta * n_x, device=dev).reshape(n_theta, n_x)
    ess_hist, n_rej, syncs = [], 0, 0

    def rejuvenate(t):
        nonlocal thetas, xs, log_ws, log_mls
        idx = systematic_resample(generator, log_W)
        thetas, log_ws, log_mls = thetas[idx], log_ws[idx], log_mls[idx]
        xs = _rows(xs, idx, n_x)
        # random-walk proposal scaled to the resampled cloud
        centered = thetas - thetas.mean(dim=0)
        cov = centered.T @ centered / n_theta + 1e-6 * torch.eye(d, dtype=dtype, device=dev)
        chol = torch.linalg.cholesky(cov)
        scale = 2.38 / math.sqrt(float(d))
        lp_cur = log_prior_fn(thetas)
        for _ in range(rejuvenation_moves):
            z = torch.randn(n_theta, d, generator=generator, dtype=dtype, device=dev)
            props = thetas + scale * z @ chol.T
            lp_prop = log_prior_fn(props)
            ml_prop, _, _, x_prop, lw_prop = run_filter(
                init_fn, step_fn, loglik_fn, ys[: t + 1], n_x, generator, props,
                batch=n_theta, ess_threshold=pf_ess_threshold)
            u = torch.rand(n_theta, generator=generator, dtype=dtype, device=dev)
            log_alpha = (lp_prop + ml_prop) - (lp_cur + log_mls)
            accept = (torch.log(1e-20 + (1.0 - 1e-20) * u) < log_alpha) & torch.isfinite(lp_prop)
            thetas = torch.where(accept.unsqueeze(-1), props, thetas)
            log_mls = torch.where(accept, ml_prop, log_mls)
            lp_cur = torch.where(accept, lp_prop, lp_cur)
            acc_x = accept.repeat_interleave(n_x).reshape(-1, *(1,) * (xs.ndim - 1))
            xs = torch.where(acc_x, x_prop, xs)
            log_ws = torch.where(accept.unsqueeze(-1), lw_prop, log_ws)

    for t in range(ys.shape[0]):
        # one bootstrap-filter step of every theta-particle
        model_params = _per_particle(thetas, n_x)
        w = torch.softmax(log_ws, dim=-1)
        ess_x = 1.0 / torch.sum(w * w, dim=-1) / n_x
        idx = systematic_resample(generator, log_ws)
        do = (ess_x < pf_ess_threshold).unsqueeze(-1)
        xs = xs[torch.where(do, idx + offset, plain).reshape(-1)]
        log_ws = torch.where(do, torch.zeros_like(log_ws), log_ws)
        xs = step_fn(generator, xs, t, model_params)
        ll = loglik_fn(xs, ys[t], t, model_params).reshape(n_theta, n_x)
        log_w_new = log_ws + ll
        incr = torch.logsumexp(log_w_new, -1) - torch.logsumexp(log_ws, -1)
        log_ws = log_w_new
        log_mls = log_mls + incr
        # evidence increment: log sum(W_j * exp(incr_j)) over the cloud
        log_Z = log_Z + torch.logsumexp(log_W + incr, 0) - torch.logsumexp(log_W, 0)
        log_W = log_W + incr
        wt = torch.softmax(log_W, dim=0)
        ess = 1.0 / torch.sum(wt * wt) / n_theta
        ess_hist.append(ess)
        syncs += 1
        if float(ess) < ess_threshold:
            rejuvenate(t)
            log_W = torch.zeros_like(log_W)
            n_rej += 1
    return {
        "thetas": thetas,
        "log_weights": log_W,
        "log_evidence": log_Z,
        "ess_history": torch.stack(ess_hist),
        "rejuvenations": n_rej,
        "theta_log_marginals": log_mls,
        "host_syncs": syncs,
    }
