"""Pareto-smoothed importance resampling (``exmc_tpu/psir.py``; Yao et
al. 2018, Zhang et al. 2022 Pathfinder §2.3).

Laplace, ADVI and Pathfinder return draws from a Gaussian q in the
compiled model's unconstrained space, so the importance ratio
log w = logp(z) - logq(z) is exact: one batched evaluation of the
log-density. PSIR Pareto-smooths the ratios' tail (the GPD fit of
``model_comparison._psis_smooth``, which also gives the k-hat
diagnostic: < 0.5 good, 0.5-0.7 usable, > 0.7 the approximation is too
far off for importance sampling to repair) and resamples the draws with
probability proportional to the smoothed weights. The smoothing and the
resampling run on the host in numpy, as in the JAX package, so the same
weights and seed give the same indices.
"""

import math
import warnings

import numpy as np
import torch

from exmc_tpu_torch.compiler import CompiledModel, compile_logp
from exmc_tpu_torch.config import default_dtype
from exmc_tpu_torch.model_comparison import _psis_smooth

__all__ = ["psir", "diag_normal_logq", "apply_psir_to_fit"]


def diag_normal_logq(z, mu, sigma):
    """log N(z | mu, diag(sigma^2)) per row of z: (S, d) -> (S,)."""
    z, mu, sigma = (torch.as_tensor(a) for a in (z, mu, sigma))
    resid = (z - mu) / sigma
    return (-0.5 * torch.sum(resid * resid, dim=-1) - torch.sum(torch.log(sigma))
            - 0.5 * z.shape[-1] * math.log(2.0 * math.pi))


def psir(ir_or_model, draws_unconstrained, logq, *, num_resample=None,
         seed=0, data=None, ncp=True, device=None):
    """Resample approximate draws toward the exact posterior.

    ``draws_unconstrained``: (S, d) proposal draws in the compiled
    model's unconstrained space; ``logq``: (S,) the proposal's
    log-density at each. Returns ``(trace, info)``: ``trace`` maps each
    free RV to (1, num_resample, *shape) constrained arrays; ``info`` has
    ``pareto_k`` (the GPD tail shape; NaN when the fit could not run),
    ``ess_is`` (1 / sum w² of the smoothed weights), ``log_weights``
    (smoothed, (S,)) and ``indices`` (the resampled rows)."""
    model = (ir_or_model if isinstance(ir_or_model, CompiledModel)
             else compile_logp(ir_or_model, ncp=ncp, device=device))
    ddata = None if data is None else model.device_data(data)
    z = torch.as_tensor(draws_unconstrained, dtype=default_dtype(),
                        device=model.device)
    if z.ndim != 2:
        raise ValueError(f"draws must be (S, d), got {tuple(z.shape)}")
    s = z.shape[0]
    logq = np.asarray(logq, np.float64).reshape(-1)
    if logq.shape[0] != s:
        raise ValueError(f"logq has {logq.shape[0]} rows, draws {s}")
    if num_resample is None:
        num_resample = s

    logp = model.logp(z, ddata).cpu().numpy().astype(np.float64)
    log_w = logp - logq
    finite = np.isfinite(log_w)
    log_w = np.where(finite, log_w, -np.inf)
    if not finite.any():
        raise ValueError("all importance ratios are non-finite (the "
                         "proposal misses the posterior's support)")
    smoothed, k_hat, fitted = _psis_smooth(
        np.where(finite, log_w, log_w[finite].min()))
    if not fitted:
        # the tail fit could not run: k-hat is unknown, not 0.0 (good)
        k_hat = float("nan")
        warnings.warn(
            "psir: the Pareto tail fit could not run (too few positive "
            "tail exceedances) — pareto_k is NaN; treat the resampled "
            "draws with suspicion", stacklevel=2)
    smoothed = np.where(finite, smoothed, -np.inf)
    w = np.exp(smoothed - smoothed.max())
    w = w / w.sum()
    ess_is = float(1.0 / np.sum(w * w))

    rng = np.random.default_rng(seed)
    idx = rng.choice(s, size=num_resample, replace=True, p=w)
    kept = z[torch.as_tensor(idx, device=z.device)]
    named = model.constrain(kept, ddata)
    trace = {k: v.cpu().numpy()[None] for k, v in named.items()}
    return trace, {
        "pareto_k": float(k_hat),
        "ess_is": ess_is,
        "log_weights": smoothed,
        "indices": idx,
    }


def apply_psir_to_fit(result, model, logq, *, seed=0, data=None):
    """An ADVI/Pathfinder-style fit dict (with ``draws`` and
    ``draws_unconstrained`` (1, S, d)) through PSIR: a new dict whose
    draws are resampled, with the diagnostics under ``"psir"``."""
    z0 = np.asarray(result["draws_unconstrained"][0])
    trace, info = psir(model, z0, logq, seed=seed, data=data)
    out = dict(result)
    out["draws"] = trace
    out["draws_unconstrained"] = z0[info["indices"]][None]
    out["psir"] = info
    return out
