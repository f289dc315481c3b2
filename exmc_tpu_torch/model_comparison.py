"""WAIC, PSIS-LOO, model comparison and the model evidence
(``exmc_tpu/model_comparison.py``).

* ``pointwise_log_likelihood``: the (draws x observation elements)
  log-likelihood matrix; the draws are inverted to the flat space at
  once, and the pointwise log-density runs over them in chunks of
  ``POINTWISE_CHUNK`` rows, so that a large trace never holds every
  (S, N) term of the graph at once on the card;
* ``waic``, ``loo`` (Pareto-smoothed by default, with a warning on
  k-hat > 0.7), ``compare`` (a ranked table with paired SEs): numpy on
  the host, as in the JAX package;
* ``log_marginal_likelihood`` (by likelihood-tempering SMC or the flow
  ELBO) and ``bayes_factor``.
"""

import math
import warnings

import numpy as np
import torch
from scipy.special import logsumexp

from exmc_tpu_torch.compiler import CompiledModel, _Graph, _make_logp, compile_logp

# flat rows per call of the pointwise log-density
POINTWISE_CHUNK = 8192


def _as_flat_draws(model: CompiledModel, trace):
    """Constrained trace (chains, draws, ...) -> (chains * draws, d) flat
    unconstrained on the model's device, transforms and NCP inverted."""
    names = [e.id for e in model.pm.entries]
    c, n = np.asarray(trace[names[0]]).shape[:2]
    return model.unconstrain_batch(
        {k: np.asarray(trace[k]).reshape((c * n,) + np.asarray(trace[k]).shape[2:])
         for k in names})


def pointwise_log_likelihood(ir, trace, data=None, ncp=True, device=None):
    """((S, n_obs) pointwise log-likelihood matrix, column keys): one
    row per draw, one column per observation element; a column key is
    the obs id, or (obs_id, j) for a vector observation."""
    model = ir if isinstance(ir, CompiledModel) else compile_logp(ir, ncp=ncp, device=device)
    if data is None:
        data = model.data
    pw_fn = _make_logp(_Graph(model.ir, model.pm, model.device, data), model.pm,
                       pointwise=True)
    flat = _as_flat_draws(model, trace)
    parts = {}
    with torch.no_grad():
        for s in range(0, flat.shape[0], POINTWISE_CHUNK):
            rows = flat[s:s + POINTWISE_CHUNK]
            for obs_id, v in pw_fn(rows).items():
                v = v.expand((rows.shape[0],) + tuple(v.shape[1:])) if v.ndim else \
                    v.expand(rows.shape[0])
                parts.setdefault(obs_id, []).append(v.reshape(rows.shape[0], -1).cpu())
    cols, keys = [], []
    for obs_id in sorted(parts):
        arr = torch.cat(parts[obs_id]).numpy()
        for j in range(arr.shape[1]):
            cols.append(arr[:, j])
            keys.append(obs_id if arr.shape[1] == 1 else (obs_id, j))
    return np.stack(cols, axis=1), keys


def waic(ir, trace, data=None, ncp=True, device=None):
    """WAIC = -2 (lppd - p_waic), with its SE."""
    ll, _ = pointwise_log_likelihood(ir, trace, data=data, ncp=ncp, device=device)
    s, n = ll.shape
    lppd_i = logsumexp(ll, axis=0) - math.log(s)
    p_waic_i = np.var(ll, axis=0, ddof=1)
    elpd_i = np.asarray(lppd_i - p_waic_i)
    elpd = float(elpd_i.sum())
    se = float(math.sqrt(n * np.var(elpd_i, ddof=1))) if n > 1 else 0.0
    return {"waic": -2.0 * elpd, "elpd_waic": elpd, "p_waic": float(p_waic_i.sum()),
            "se": 2.0 * se, "elpd_se": se, "pointwise": elpd_i}


def _psis_smooth(log_w):
    """Pareto-smoothed importance weights for ONE observation
    (Vehtari/Simpson/Gelman 2015). log_w: (S,) raw log importance
    weights. Returns (smoothed log_w, pareto k-hat, fitted):
    ``fitted=False`` means the GPD tail fit could not run (too few
    positive exceedances) and k-hat is a flat-tail 0.0 that a caller
    wanting the 'did it work?' answer must treat as unknown."""
    s = log_w.shape[0]
    m = max(int(np.ceil(min(0.2 * s, 3.0 * np.sqrt(s)))), 5)
    order = np.argsort(log_w)
    tail_idx = order[-m:]
    tail = np.exp(log_w[tail_idx] - log_w.max())
    cutoff = np.exp(log_w[order[-m - 1]] - log_w.max())
    exceed = tail - cutoff
    # Zhang & Stephens (2009) profile-posterior GPD fit
    x = np.sort(exceed[exceed > 0])
    if x.size < 5:
        return log_w, 0.0, False
    n = x.size
    x_star = x[max(int(n / 4 + 0.5) - 1, 0)]
    mth = 30 + int(np.sqrt(n))
    jj = np.arange(1, mth + 1)
    thetas = 1.0 / x[-1] + (1.0 - np.sqrt(mth / (jj - 0.5))) / (3.0 * x_star)
    # the loo package's convention (shape xi): for each theta,
    # k = mean(log1p(-theta*x)) (positive = heavy tail), profile
    # loglik l = n*(log(-theta/k) - k - 1)
    ks = np.array([np.mean(np.log1p(-t * x)) for t in thetas])
    with np.errstate(divide="ignore", invalid="ignore"):
        ls = n * (np.log(-thetas / ks) - ks - 1.0)
    ls = np.where(np.isfinite(ls), ls, -np.inf)
    w = np.exp(ls - ls.max())
    w = w / w.sum()
    theta_hat = float(np.sum(thetas * w))
    k_hat = float(np.mean(np.log1p(-theta_hat * x)))
    sigma_hat = -k_hat / theta_hat if theta_hat != 0 else 0.0
    # replace the tail by expected GPD order statistics
    if sigma_hat > 0 and np.isfinite(k_hat):
        probs = (np.arange(1, m + 1) - 0.5) / m
        if abs(k_hat) < 1e-6:
            quant = -sigma_hat * np.log1p(-probs)
        else:
            quant = sigma_hat / k_hat * ((1 - probs) ** (-k_hat) - 1.0)
        smoothed_tail = np.log(cutoff + quant) + log_w.max()
        new = log_w.copy()
        new[tail_idx] = np.minimum(np.sort(smoothed_tail), log_w.max())
        return new, k_hat, True
    fitted = bool(np.isfinite(k_hat))
    return log_w, k_hat if fitted else 0.0, fitted


def loo(ir, trace, data=None, ncp=True, psis=True, device=None):
    """LOO by importance sampling: Pareto-smoothed (``psis=True``, with
    per-observation ``pareto_k`` and a warning when any k > 0.7) or the
    plain harmonic-mean estimate (``psis=False``)."""
    ll, _ = pointwise_log_likelihood(ir, trace, data=data, ncp=ncp, device=device)
    s, n = ll.shape
    if psis:
        elpd_list, k_list = [], []
        for j in range(n):
            log_w = -ll[:, j]
            log_w = log_w - log_w.max()
            log_w, k_hat, _ = _psis_smooth(log_w)
            elpd_list.append(float(logsumexp(log_w + ll[:, j]) - logsumexp(log_w)))
            k_list.append(k_hat)
        elpd_i = np.asarray(elpd_list)
        pareto_k = np.asarray(k_list)
    else:
        elpd_i = np.asarray(-logsumexp(-ll, axis=0) + math.log(s))
        pareto_k = None
    elpd = float(elpd_i.sum())
    lppd_i = logsumexp(ll, axis=0) - math.log(s)
    se = float(math.sqrt(n * np.var(elpd_i, ddof=1))) if n > 1 else 0.0
    out = {"loo": -2.0 * elpd, "elpd_loo": elpd, "p_loo": float(lppd_i.sum() - elpd),
           "se": 2.0 * se, "elpd_se": se, "pointwise": elpd_i}
    if pareto_k is not None:
        out["pareto_k"] = pareto_k
        n_bad = int((pareto_k > 0.7).sum())
        if n_bad:
            warnings.warn(
                f"PSIS-LOO: {n_bad}/{n} observation(s) have Pareto k-hat > 0.7; "
                "their elpd contributions are unreliable (consider K-fold CV or "
                "refitting without them).", stacklevel=2)
    return out


def compare(models, data=None, criterion="waic", device=None):
    """Ranked comparison table: ``models`` is {name: (ir, trace)}. Rows
    best first, each with ``delta_elpd`` from the best and its paired SE
    from the pointwise elpd differences."""
    fn = waic if criterion == "waic" else loo
    elpd_key = "elpd_waic" if criterion == "waic" else "elpd_loo"
    rows = []
    for name, (ir, trace) in models.items():
        res = fn(ir, trace, data=data, device=device)
        rows.append({"name": name, **res, "elpd": res[elpd_key]})
    rows.sort(key=lambda r: -r["elpd"])
    best = rows[0]["elpd"]
    best_pw = np.asarray(rows[0]["pointwise"])
    for i, r in enumerate(rows):
        r["rank"] = i
        r["delta_elpd"] = best - r["elpd"]
        pw = np.asarray(r["pointwise"])
        if i == 0 or pw.shape != best_pw.shape:
            r["delta_elpd_se"] = 0.0
        else:
            d = best_pw - pw
            r["delta_elpd_se"] = (float(math.sqrt(d.shape[0] * np.var(d, ddof=1)))
                                  if d.shape[0] > 1 else 0.0)
    return rows


def log_marginal_likelihood(ir, *, method="smc", data=None, ncp=True, seed=0,
                            device=None, **kwargs):
    """log p(y), the model evidence. ``method="smc"``: the
    likelihood-tempering SMC estimate (kwargs go to ``smc_sample``);
    ``method="flow"``: the flow ELBO, a lower bound (``flow=`` an
    existing ``FlowFit``, or kwargs for ``flow_fit``). Returns
    {"log_evidence", "method", ...}."""
    if method == "smc":
        from exmc_tpu_torch.smc import smc_sample

        _, info = smc_sample(ir, data=data, ncp=ncp, seed=seed, tempering="likelihood",
                             device=device, **kwargs)
        if not info["converged"]:
            raise RuntimeError("SMC beta ladder did not reach 1.0; no evidence "
                               "estimate (raise max_stages)")
        return {"log_evidence": info["log_evidence"], "method": "smc",
                "num_stages": info["num_stages"], "betas": info["betas"]}
    if method == "flow":
        from exmc_tpu_torch.flows import flow_fit

        fit = kwargs.pop("flow", None)
        if fit is not None and kwargs:
            raise ValueError(
                "pass flow= (an existing fit) OR fit options "
                f"({sorted(kwargs)}), not both — the options would be "
                "silently ignored")
        if fit is None:
            fit = flow_fit(ir, data=data, ncp=ncp, seed=seed, device=device, **kwargs)
        elbo = float(np.mean(fit.elbo_history[-100:]))
        return {"log_evidence": elbo, "method": "flow", "lower_bound": True,
                "pareto_k": fit.psis_diagnostic(seed=seed + 1)}
    raise ValueError(f"method must be 'smc' or 'flow', got {method!r}")


def bayes_factor(ir_a, ir_b, *, method="smc", data=None, ncp=True, seed=0,
                 device=None, **kwargs):
    """log10 Bayes factor of model A over model B, both evidences by
    ``log_marginal_likelihood`` with the same settings."""
    za = log_marginal_likelihood(ir_a, method=method, data=data, ncp=ncp, seed=seed,
                                 device=device, **kwargs)
    zb = log_marginal_likelihood(ir_b, method=method, data=data, ncp=ncp, seed=seed,
                                 device=device, **kwargs)
    return {"log10_bf": (za["log_evidence"] - zb["log_evidence"]) / math.log(10.0),
            "evidence_a": za, "evidence_b": zb}
