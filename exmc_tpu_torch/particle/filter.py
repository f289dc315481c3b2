"""Bootstrap particle filter (``exmc_tpu/particle/filter.py``).

Model interface:

    init_fn(generator, n, params)        -> x0: (n, *state_shape)
    step_fn(generator, x, t, params)     -> x': (n, *state_shape)
    loglik_fn(x, y, t, params)           -> (n,) per-particle obs log-liks

``particle_filter`` runs the T-step filter with adaptive systematic
resampling (when the normalized ESS drops below ``ess_threshold``) and
returns the unbiased log-marginal-likelihood estimate
log p^(y_{1:T} | params) with the filtered means: the inner loop of
PMCMC and SMC^2. The JAX package's ``lax.cond`` on the ESS is a mask
here, so the filter never reads the device on the host.

Batches of parameter points (PMMH chains, SMC^2's theta-particles) run
as ONE filter over B * n particles: the model callables then see
``params`` with one row per particle (each leaf repeated n times), so
code written for one point (``params["beta"] * x[:, 1]``,
``params[..., 0]``) applies elementwise unchanged, while the weights,
the ESS and the resampling stay per point.
"""

import torch

from exmc_tpu_torch.config import default_dtype


def systematic_resample(generator, log_w, n=None, u0=None):
    """Systematic resampling: ancestor indices (..., n) for log-weights
    (..., N), per row. One uniform offset u0 ~ U(0, 1/n) per row (drawn
    from ``generator``, or given as ``u0`` (...)), n evenly spaced
    points through the normalized CDF."""
    if n is None:
        n = log_w.shape[-1]
    w = torch.softmax(log_w, dim=-1)
    cdf = torch.cumsum(w, dim=-1)
    if u0 is None:
        u0 = torch.rand(log_w.shape[:-1], generator=generator, dtype=w.dtype,
                        device=w.device) / n
    pts = u0.unsqueeze(-1) + torch.arange(n, dtype=w.dtype, device=w.device) / n
    idx = torch.searchsorted(cdf, pts.expand(*cdf.shape[:-1], n).contiguous())
    return torch.clamp(idx, 0, log_w.shape[-1] - 1)


def _per_particle(params, n):
    """Each leaf of a batch of B points' params, repeated for its n
    particles: (B, ...) -> (B * n, ...)."""
    if isinstance(params, dict):
        return {k: _per_particle(v, n) for k, v in params.items()}
    if not isinstance(params, torch.Tensor) or params.ndim == 0:
        return params
    return torch.repeat_interleave(params, n, dim=0)


def _batch_size(params):
    leaves = list(params.values()) if isinstance(params, dict) else [params]
    return max((int(v.shape[0]) for v in leaves
                if isinstance(v, torch.Tensor) and v.ndim), default=1)


def run_filter(init_fn, step_fn, loglik_fn, ys, n, generator, params, batch=None,
               ess_threshold=0.5, resample_u=None):
    """The bootstrap filter for ``batch`` parameter points (None: one
    point, ``params`` passed to the model as given; an int B: params
    leaves with a leading axis of B, expanded per particle).
    ``resample_u`` (T, B) injects the resampling offsets u0.

    Returns log_marginal (B,), filtered means (T, B, *state), ess (T, B),
    the final particles (B * n, *state) and log-weights (B, n)."""
    b = 1 if batch is None else batch
    model_params = params if batch is None else _per_particle(params, n)
    dev = generator.device
    dtype = default_dtype()
    ys = torch.as_tensor(ys, dtype=dtype, device=dev)
    x = init_fn(generator, b * n, model_params)
    log_w = torch.zeros(b, n, dtype=dtype, device=dev)
    log_ml = torch.zeros(b, dtype=dtype, device=dev)
    offset = (torch.arange(b, device=dev) * n).unsqueeze(-1)
    means, esss = [], []
    for t in range(ys.shape[0]):
        w = torch.softmax(log_w, dim=-1)
        ess = 1.0 / torch.sum(w * w, dim=-1) / n
        # adaptive systematic resampling, as a mask
        idx = systematic_resample(generator, log_w,
                                  u0=None if resample_u is None else resample_u[t])
        do = ess < ess_threshold
        keep = torch.where(do.unsqueeze(-1), idx + offset, torch.arange(b * n, device=dev)
                           .reshape(b, n))
        x = x[keep.reshape(-1)]
        log_w = torch.where(do.unsqueeze(-1), torch.zeros_like(log_w), log_w)

        x = step_fn(generator, x, t, model_params)
        ll = loglik_fn(x, ys[t], t, model_params).reshape(b, n)
        log_w_new = log_w + ll
        # incremental marginal likelihood: log sum(w_prev * exp(ll))
        log_ml = log_ml + torch.logsumexp(log_w_new, -1) - torch.logsumexp(log_w, -1)
        w_new = torch.softmax(log_w_new, dim=-1)
        xs = x.reshape(b, n, *x.shape[1:])
        means.append(torch.sum(w_new.reshape(b, n, *(1,) * (x.ndim - 1)) * xs, dim=1))
        esss.append(ess)
        log_w = log_w_new
    return log_ml, torch.stack(means), torch.stack(esss), x, log_w


def particle_filter(init_fn, step_fn, loglik_fn, ys, n_particles, generator, params,
                    ess_threshold=0.5, resample_u=None):
    """Bootstrap PF over observations ``ys`` (T, *obs_shape), on the
    generator's device. ``resample_u`` (T,) injects the resampling
    offsets (for lockstep tests).

    Returns dict with:
      log_marginal — unbiased log p^(y_{1:T})
      filtered_means — (T, *state_shape) weighted particle means
      ess — (T,) normalized effective sample size per step
      final_particles, final_log_weights
    """
    ru = None if resample_u is None else torch.as_tensor(
        resample_u, dtype=default_dtype(), device=generator.device).reshape(-1, 1)
    log_ml, means, ess, x, log_w = run_filter(
        init_fn, step_fn, loglik_fn, ys, n_particles, generator, params,
        ess_threshold=ess_threshold, resample_u=ru)
    return {"log_marginal": log_ml[0], "filtered_means": means[:, 0], "ess": ess[:, 0],
            "final_particles": x, "final_log_weights": log_w[0]}


def make_log_marginal_fn(init_fn, step_fn, loglik_fn, ys, n_particles,
                         ess_threshold=0.5):
    """(generator, params) -> log p^(y | params): the PMCMC/SMC^2
    building block. ``params``' leaves are scalars (one point; returns a
    0-d tensor) or share a leading axis of B points (returns (B,)), each
    point with its own n_particles filter."""

    def fn(generator, params):
        leaves = list(params.values()) if isinstance(params, dict) else [params]
        batched = any(isinstance(v, torch.Tensor) and v.ndim for v in leaves)
        log_ml = run_filter(init_fn, step_fn, loglik_fn, ys, n_particles, generator,
                            params, batch=_batch_size(params) if batched else None,
                            ess_threshold=ess_threshold)[0]
        return log_ml if batched else log_ml[0]

    return fn
