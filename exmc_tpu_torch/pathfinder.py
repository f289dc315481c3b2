"""Pathfinder variational inference (``exmc_tpu/pathfinder.py``; Zhang et
al. 2022 as the reference's pathfinder.ex realizes it).

An L-BFGS path by the two-loop recursion over a history of 6 pairs
(fixed step 0.01 for ``method="diag"``, a damped-Newton 0.5 for
``"lowrank"``), a Gaussian fit at each path point (diag: sigma =
1/sqrt(|grad| + 1e-6); lowrank: ``pathfinder_lowrank``), the MC-ELBO of
every point as one batch of the value-and-grad, and draws from the best
point's fit. The path is a host loop with no sync: every choice inside
it is a ``torch.where``. The JAX package caches its jitted closures per
(model, data) identity; here the costly parts are the model's captured
graphs per batch shape, which the model keeps, so there is no cache.

Randomness: the start (d,) uniform on (-2, 2), the ELBO noise
(num_iters, num_elbo_draws, d) and the draw noise (num_draws, d) come
from a ``torch.Generator`` seeded from ``seed``, or are injected
(``start=``, ``elbo_noise=``, ``draw_noise=``).
"""

import math

import numpy as np
import torch

from exmc_tpu_torch.compiler import CompiledModel, compile_logp
from exmc_tpu_torch.config import default_dtype
from exmc_tpu_torch.pathfinder_lowrank import (
    lowrank_factors,
    marginal_sd,
    sample_and_logq,
)
from exmc_tpu_torch.psir import apply_psir_to_fit, diag_normal_logq

HISTORY = 6
ALPHA = 0.01
LOWRANK_STEP = 0.5
PATH_SEED_STRIDE = 1_000_003


def _two_loop(grad, s_hist, y_hist, rho_hist, valid):
    """L-BFGS two-loop recursion over fixed-size history buffers."""
    q = grad
    zero = grad.new_zeros(())
    alphas = [None] * HISTORY
    for i in range(HISTORY - 1, -1, -1):
        a = torch.where(valid[i], rho_hist[i] * torch.sum(s_hist[i] * q), zero)
        q = q - a * y_hist[i]
        alphas[i] = a
    # initial scaling gamma = s.y / y.y of the most recent pair
    sy = torch.sum(s_hist[-1] * y_hist[-1])
    yy = torch.sum(y_hist[-1] * y_hist[-1])
    gamma = torch.where(valid[-1] & (yy > 0), sy / torch.clamp_min(yy, 1e-12),
                        torch.ones_like(sy))
    r = gamma * q
    for i in range(HISTORY):
        b = torch.where(valid[i], rho_hist[i] * torch.sum(y_hist[i] * r), zero)
        r = r + s_hist[i] * (alphas[i] - b)
    return r


def _push(hist, new, ok):
    """The history with ``new`` appended (oldest dropped) where ``ok``."""
    rolled = torch.cat([hist[1:], new.unsqueeze(0)], dim=0)
    return torch.where(ok, rolled, hist)


def _lbfgs_path(vag1, x0, num_iters, step, lowrank=False):
    """The L-BFGS path from ``x0``: per iteration the point, and for
    ``lowrank`` the history buffers and gamma; for diag the fitted
    sigma. ``vag1(x (d,)) -> (logp (), grad (d,))``."""
    d = x0.shape[0]
    dt, dev = x0.dtype, x0.device
    x = x0
    logp, grad = vag1(x0)
    s_h = torch.zeros(HISTORY, d, dtype=dt, device=dev)
    y_h = torch.zeros(HISTORY, d, dtype=dt, device=dev)
    rho_h = torch.zeros(HISTORY, dtype=dt, device=dev)
    valid = torch.zeros(HISTORY, dtype=torch.bool, device=dev)
    gamma = torch.ones((), dtype=dt, device=dev)
    out = {"mu": [], "sigma": [], "s": [], "y": [], "valid": [], "gamma": []}
    for _ in range(num_iters):
        # ascent direction on logp (minimize -logp)
        direction = _two_loop(-grad, s_h, y_h, rho_h, valid)
        x_new = x - step * direction
        logp_new, grad_new = vag1(x_new)
        ok = torch.isfinite(logp_new) & torch.isfinite(grad_new).all()
        x_new = torch.where(ok, x_new, x)
        logp_new = torch.where(ok, logp_new, logp)
        grad_new = torch.where(ok, grad_new, grad)
        s = x_new - x
        y = -(grad_new - grad)  # gradient of -logp
        sy = torch.sum(s * y)
        pair_ok = ok & (sy > 1e-12)
        s_h = _push(s_h, s, pair_ok)
        y_h = _push(y_h, y, pair_ok)
        rho_h = _push(rho_h, 1.0 / torch.clamp_min(sy, 1e-12), pair_ok)
        valid = _push(valid, torch.ones((), dtype=torch.bool, device=dev), pair_ok)
        x, logp, grad = x_new, logp_new, grad_new
        out["mu"].append(x)
        if lowrank:
            gamma = torch.where(pair_ok, sy / torch.clamp_min(torch.sum(y * y), 1e-12),
                                gamma)
            out["s"].append(s_h)
            out["y"].append(y_h)
            out["valid"].append(valid)
            out["gamma"].append(gamma)
        else:
            # diag-normal fit at this point (pathfinder.ex:156-171)
            out["sigma"].append(1.0 / torch.sqrt(torch.abs(grad) + 1e-6))
    return {k: torch.stack(v) for k, v in out.items() if v}


def _draws(model, gen, num_iters, num_elbo_draws, num_draws, start,
           elbo_noise, draw_noise):
    """The run's three random inputs, drawn from ``gen`` in this order
    where not injected."""
    d, dt, dev = model.size, default_dtype(), model.device

    def get(x, make):
        return make() if x is None else torch.as_tensor(x, dtype=dt, device=dev)

    start = get(start, lambda: torch.rand(d, generator=gen, dtype=dt, device=dev)
                * 4.0 - 2.0)
    elbo_noise = get(elbo_noise, lambda: torch.randn(
        num_iters, num_elbo_draws, d, generator=gen, dtype=dt, device=dev))
    draw_noise = get(draw_noise, lambda: torch.randn(
        num_draws, d, generator=gen, dtype=dt, device=dev))
    return start, elbo_noise, draw_noise


def _batch_logp(vag, z):
    """logp of (..., d) points as one value-and-grad batch; non-finite
    values -> -1e30."""
    lps, _ = vag(z.reshape(-1, z.shape[-1]))
    lps = lps.reshape(z.shape[:-1])
    return torch.where(torch.isfinite(lps), lps, torch.full_like(lps, -1e30))


def _fit_from_path(vag, path, eps, u, lowrank):
    """The MC-ELBO of every path point (one value-and-grad batch of
    num_iters * num_elbo_draws rows), the best point, its fit and the
    draws ``u`` pushed through it. Returns (elbos, best, mu, sigma, z,
    logq of z)."""
    if not lowrank:
        mu_p, sig_p = path["mu"], path["sigma"]
        lps = _batch_logp(vag, mu_p.unsqueeze(1) + sig_p.unsqueeze(1) * eps)
        elbos = torch.mean(lps, dim=-1) + torch.sum(torch.log(sig_p), dim=-1)
        best = int(torch.argmax(elbos))
        mu, sigma = mu_p[best], sig_p[best]
        z = mu + sigma * u
        return elbos, best, mu, sigma, z, diag_normal_logq(z, mu, sigma)
    d = path["mu"].shape[-1]
    alpha = torch.clamp_min(path["gamma"], 1e-8).unsqueeze(-1).expand(-1, d)
    q, lch, logdet = lowrank_factors(alpha, path["s"], path["y"], path["valid"])
    zs, logqs = sample_and_logq(eps, path["mu"], alpha, q, lch, logdet)
    elbos = torch.mean(_batch_logp(vag, zs) - logqs, dim=-1)
    elbos = torch.where(torch.isfinite(elbos), elbos, torch.full_like(elbos, -math.inf))
    best = int(torch.argmax(elbos))
    # the best point's factors again, alone, as the JAX package rebuilds
    # them for its draws
    a1 = alpha[best]
    q1, l1, ld1 = lowrank_factors(a1, path["s"][best], path["y"][best],
                                  path["valid"][best])
    z, logq = sample_and_logq(u, path["mu"][best], a1, q1, l1, ld1)
    return elbos, best, path["mu"][best], marginal_sd(a1, q1, l1), z, logq


def pathfinder_fit(ir, *, num_iters=100, num_draws=1000, num_elbo_draws=20,
                   seed=0, data=None, ncp=True, method="diag", psir=False,
                   device=None, start=None, elbo_noise=None, draw_noise=None):
    """Run Pathfinder on ``device`` (default ``"cuda"``; a compiled model
    keeps its own); returns {draws (constrained trace), draws_unconstrained,
    mu, sigma, elbo_path, best_iter}.

    ``method="diag"`` is the reference's per-coordinate fit;
    ``"lowrank"`` the paper's low-rank-plus-diagonal inverse-Hessian
    covariance from the curvature pairs (``pathfinder_lowrank``), whose
    ``sigma`` is the marginal sd vector. ``psir=True`` resamples the
    draws by Pareto-smoothed importance resampling (``result["psir"]``)."""
    if method not in ("diag", "lowrank"):
        raise ValueError(f"unknown pathfinder method {method!r} "
                         "(expected 'diag' or 'lowrank')")
    model = (ir if isinstance(ir, CompiledModel)
             else compile_logp(ir, ncp=ncp, device=device))
    ddata = None if data is None else model.device_data(data)

    def vag(z):
        return model.value_and_grad(z, ddata)

    def vag1(x):
        lp, g = vag(x.unsqueeze(0))
        return lp[0], g[0]

    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    x0, eps, u = _draws(model, gen, num_iters, num_elbo_draws, num_draws,
                        start, elbo_noise, draw_noise)
    lowrank = method == "lowrank"
    path = _lbfgs_path(vag1, x0, num_iters, LOWRANK_STEP if lowrank else ALPHA,
                       lowrank=lowrank)
    elbos, best, mu, sigma, z, logq = _fit_from_path(vag, path, eps, u, lowrank)
    trace = {k: v.cpu().numpy()[None] for k, v in model.constrain(z, ddata).items()}
    result = {
        "mu": mu.cpu().numpy(),
        "sigma": sigma.cpu().numpy(),
        "elbo_path": elbos.cpu().numpy(),
        "best_iter": best,
        "draws": trace,
        "draws_unconstrained": z.cpu().numpy()[None],
    }
    if lowrank:
        result["method"] = "lowrank"
    if psir:
        # the lowrank q's exact log-density came with its draws (its
        # marginal-sd "sigma" is not a diag q)
        result = apply_psir_to_fit(result, model, logq.cpu().numpy(),
                                   seed=seed + 101, data=data)
    return result


def pathfinder_init(ir, num_chains, *, seed=0, data=None, ncp=True,
                    num_paths=8, num_iters=150, device=None, path_noise=None):
    """Multi-path Pathfinder MCMC initialization (Zhang et al. 2022 §1):
    ``num_paths`` independent paths from random starts, run one after
    the other (path p seeded ``seed + 1_000_003 p``), the path with the
    best MC-ELBO kept, and ``(num_chains, d)`` unconstrained draws from
    its fit returned as per-chain inits. ``path_noise``: one dict of
    ``pathfinder_fit``'s injected draws per path."""
    model = (ir if isinstance(ir, CompiledModel)
             else compile_logp(ir, ncp=ncp, device=device))
    best = None
    for p in range(num_paths):
        r = pathfinder_fit(model, num_iters=num_iters, num_draws=num_chains,
                           num_elbo_draws=20, seed=seed + PATH_SEED_STRIDE * p,
                           data=data, **({} if path_noise is None else path_noise[p]))
        e = float(np.max(r["elbo_path"]))
        if best is None or e > best[0]:
            best = (e, r)
    return best[1]["draws_unconstrained"][0][:num_chains]
