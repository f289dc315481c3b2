"""Hierarchical Weibull reliability model (``exmc_tpu/benchmarks/
reliability.py``): d = 4 + 2 * n_types (44 at 20 types), four
hyperparameters and two non-centered per-type vectors, a right-censored
Weibull likelihood over the whole dataset as one ``Custom`` factor that
reads the observations from ``Builder.data``.

``simulate_data`` draws with numpy's seeded generator exactly as the
JAX package does, so both packages see the same data."""

import numpy as np
import torch

from exmc_tpu_torch import dists
from exmc_tpu_torch.ir import Builder


def simulate_data(n_types=20, n_per_type=30, censor_time=8.0, seed=0):
    """Per-type Weibull lifetimes, right-censored at a fixed inspection
    time: ((n, 3) float32 rows of (time, censored flag, type index),
    {"log_k", "log_l"} of the types)."""
    rng = np.random.default_rng(seed)
    log_k = rng.normal(0.5, 0.3, size=n_types)
    log_l = rng.normal(2.0, 0.4, size=n_types)
    rows = []
    for j in range(n_types):
        k, lam = np.exp(log_k[j]), np.exp(log_l[j])
        t = lam * rng.weibull(k, size=n_per_type)
        censored = t > censor_time
        t = np.minimum(t, censor_time)
        for ti, ci in zip(t, censored):
            rows.append((ti, 1.0 if ci else 0.0, float(j)))
    return np.asarray(rows, np.float32), {"log_k": log_k, "log_l": log_l}


def _loglik(_x, params, data=None):
    """The censored Weibull log-likelihood of the data, per chain: the
    params carry a leading chain axis (the per-type vectors (C, T), the
    hyperparameters (C, 1) after alignment), ``data`` is (1, n, 3)."""
    rows = data[0]
    times, censored = rows[:, 0], rows[:, 1]
    type_idx = rows[:, 2].to(torch.long)
    log_k = params["log_k_mean"] + params["log_k_sigma"] * params["k_raw"]
    log_l = params["log_l_mean"] + params["log_l_sigma"] * params["l_raw"]
    k = torch.exp(torch.clamp(log_k, -3.0, 3.0))
    lam = torch.exp(torch.clamp(log_l, -3.0, 6.0))
    k_i, lam_i = k[:, type_idx], lam[:, type_idx]
    zt = torch.clamp_min(times, 1e-10) / lam_i
    log_pdf = torch.log(k_i) - torch.log(lam_i) + (k_i - 1.0) * torch.log(zt) - zt ** k_i
    log_sf = -(zt ** k_i)
    return torch.sum(torch.where(censored > 0.5, log_sf, log_pdf), dim=-1)


def build(data, n_types=20):
    """The d = 4 + 2 * n_types IR; ``data`` is (n, 3) rows of (time,
    censored flag, type index)."""
    lik = dists.Custom(logpdf_fn=_loglik, support="real")
    ir = Builder.new_ir()
    ir = Builder.data(ir, np.asarray(data, np.float32))
    ir = Builder.rv(ir, "log_k_mean", dists.Normal, {"mu": 0.5, "sigma": 1.0})
    ir = Builder.rv(ir, "log_k_sigma", dists.HalfCauchy, {"scale": 1.0})
    ir = Builder.rv(ir, "log_l_mean", dists.Normal, {"mu": 2.0, "sigma": 1.0})
    ir = Builder.rv(ir, "log_l_sigma", dists.HalfCauchy, {"scale": 1.0})
    ir = Builder.rv(ir, "k_raw", dists.Normal, {"mu": 0.0, "sigma": 1.0},
                    shape=(n_types,))
    ir = Builder.rv(ir, "l_raw", dists.Normal, {"mu": 0.0, "sigma": 1.0},
                    shape=(n_types,))
    ir = Builder.rv(ir, "lik", lik, {
        "log_k_mean": "log_k_mean", "log_k_sigma": "log_k_sigma",
        "log_l_mean": "log_l_mean", "log_l_sigma": "log_l_sigma",
        "k_raw": "k_raw", "l_raw": "l_raw",
    })
    return Builder.obs(ir, "lik_obs", "lik", 0.0)
