"""Pareto smoothing of importance weights (``exmc_tpu/model_comparison.py``,
``_psis_smooth``), the part PSIR needs. The JAX package's version is
numpy, and so is this copy; WAIC, LOO and ``compare`` wait for the rest
of the module's port.
"""

import numpy as np


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
