"""Plain reference of eight schools, in float64 on the CPU.

The program samples mu, u = log(tau) and z_j = (theta_j - mu) / tau (its
log transform of the half-Cauchy scale and its automatic non-centring).
The reference works that form out again from the constrained draws, and
gives the log-density there, its gradient, and the posterior's moments
by quadrature: theta_j given (mu, tau) is normal, so the posterior of
(mu, log tau) is two-dimensional and a fine grid integrates it exactly.
"""

import math

import numpy as np
import torch

# the control: this reference in the precision below the configuration's
CONTROL = "bfloat16"

_DTYPES = {"float64": torch.float64, "bfloat16": torch.bfloat16}
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def unconstrain(trace, data, cfg):
    """{name: (..., ) constrained} -> {name: (...,) unconstrained}, float64."""
    mu = np.asarray(trace["mu"], np.float64)
    tau = np.asarray(trace["tau"], np.float64)
    out = {"mu": mu, "tau": np.log(tau)}
    for j in range(cfg["J"]):
        out[f"theta_{j}"] = (np.asarray(trace[f"theta_{j}"], np.float64) - mu) / tau
    return out


def _normal(x, mu, sd):
    return -0.5 * ((x - mu) / sd) ** 2 - np.log(sd) - _HALF_LOG_2PI


def logp_and_grad(u, data, cfg, precision="float64", device=None):
    """Log-density of the unconstrained points ``u`` ({name: (n,)}) and its
    gradient ({name: (n,)}), both float64 numpy, computed in
    ``precision``."""
    dt = _DTYPES[precision]
    names = ["mu", "tau"] + [f"theta_{j}" for j in range(cfg["J"])]
    leaves = {k: torch.tensor(np.asarray(u[k]), dtype=dt, requires_grad=True)
              for k in names}
    mu, lt = leaves["mu"], leaves["tau"]
    tau = torch.exp(lt)
    s = cfg["tau_prior_scale"]
    lp = _normal(mu, 0.0, cfg["mu_prior_sd"])
    lp = lp + (math.log(2.0 / (math.pi * s)) - torch.log1p((tau / s) ** 2)) + lt
    for j in range(cfg["J"]):
        z = leaves[f"theta_{j}"]
        lp = lp + _normal(z, 0.0, 1.0)
        lp = lp + _normal(float(data["y"][j]), mu + tau * z, float(data["sigma"][j]))
    grads = torch.autograd.grad(lp.sum(), [leaves[k] for k in names])
    return (lp.detach().double().numpy(),
            {k: g.double().numpy() for k, g in zip(names, grads)})


def rounding_allowance(x, g, data, cfg, eps):
    """Nats by which the log-density can move when the reported draws
    ``x`` ({name: (n,)} constrained) move by their rounding to the
    trace's precision (unit roundoff ``eps``). In the sampled
    coordinates the rounding moves mu by w_mu = 2 eps |mu|, log tau by 2
    eps, and z_j = (theta_j - mu) / tau by w_j = (2 eps (|theta_j| +
    |mu|) + w_mu) / tau + 2 eps |z_j|: near tau = 0 a reported theta_j
    holds z_j only that far. The allowance is the first-order change,
    |g| w, plus z_j's second-order one, (1 + tau^2 / sigma_j^2) w_j^2 / 2.
    ``g`` is the gradient in the sampled coordinates."""
    mu, tau = np.asarray(x["mu"], np.float64), np.asarray(x["tau"], np.float64)
    w_mu = 2.0 * eps * np.abs(mu)
    total = np.abs(g["mu"]) * w_mu + np.abs(g["tau"]) * 2.0 * eps
    for j in range(cfg["J"]):
        theta = np.asarray(x[f"theta_{j}"], np.float64)
        z = (theta - mu) / tau
        w = (2.0 * eps * (np.abs(theta) + np.abs(mu)) + w_mu) / tau + 2.0 * eps * np.abs(z)
        curv = 1.0 + (tau / data["sigma"][j]) ** 2
        total = total + np.abs(g[f"theta_{j}"]) * w + 0.5 * curv * w * w
    return total


def posterior(data, cfg, seed=0, device=None):
    """{name: (mean, sd, se)} of the constrained parameters, by the
    trapezoid rule on a grid of (mu, log tau), with theta integrated
    analytically; ``se``, the error of the mean, is 0."""
    y, sig = data["y"], data["sigma"]
    mu = np.linspace(-40.0, 50.0, 901)
    lt = np.linspace(math.log(1e-8), math.log(1e4), 1501)
    m, l = np.meshgrid(mu, lt, indexing="ij")
    tau2 = np.exp(2.0 * l)
    s = cfg["tau_prior_scale"]
    lw = _normal(m, 0.0, cfg["mu_prior_sd"]) - np.log1p(tau2 / s**2) + l
    for j in range(cfg["J"]):
        lw = lw + _normal(y[j], m, np.sqrt(sig[j] ** 2 + tau2))
    w = np.exp(lw - lw.max())
    w /= w.sum()

    def moments(v, var=0.0):
        mean = float((w * v).sum())
        return mean, math.sqrt(float((w * (var + v * v)).sum()) - mean * mean)

    out = {"mu": moments(m), "tau": moments(np.exp(l))}
    for j in range(cfg["J"]):
        cm = (y[j] * tau2 + m * sig[j] ** 2) / (tau2 + sig[j] ** 2)
        cv = sig[j] ** 2 * tau2 / (tau2 + sig[j] ** 2)
        out[f"theta_{j}"] = moments(cm, cv)
    return {k: (np.asarray(a), np.asarray(b), np.zeros(())) for k, (a, b) in out.items()}
