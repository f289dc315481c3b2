"""Generalized linear model builders (``exmc_tpu/glm.py``).

``glm(m, X, y, family=...)`` adds coefficients, intercept, the linear
predictor, the family's link and likelihood, and the observation to a
Model in one call, with weakly-informative priors auto-scaled to the
predictors (the rstanarm default: coefficient prior sd 2.5 / sd(x_j),
intercept 2.5 * sd of y). Everything is a plain IR graph, so every
engine, diagnostic, SBC and LOO/WAIC works unchanged.

Families: ``normal`` (identity link, HalfNormal noise), ``robust``
(StudentT likelihood, Gamma(2, 0.1) prior on df), ``logistic``
(Bernoulli logits), ``poisson`` (log link), ``negbin`` (log link,
HalfNormal overdispersion).

``glm_linpred(trace, X)`` evaluates the posterior linear predictor at
new X for every draw.
"""

import numpy as np
import torch

from exmc_tpu_torch.config import default_dtype, np_dtype, prepare_device
from exmc_tpu_torch.math import const_like

FAMILIES = ("normal", "robust", "logistic", "poisson", "negbin")

__all__ = ["glm", "glm_linpred", "FAMILIES"]


class LinearPredictor:
    """``x @ b (+ b0)`` of one point over the constant (n, p) design
    matrix ``x``: the det callable of a GLM's linear predictor. As this
    type, and not an opaque function, it tells the compiler its structure
    (``compiler.glm_logit_terms``)."""

    def __init__(self, x):
        self.x = x
        self.x_of = const_like(x)

    def __call__(self, b, b0=None):
        eta = self.x_of(b) @ b
        return eta if b0 is None else eta + b0


def glm(m, X, y, *, family="normal", name="beta", intercept=True,
        coef_scale=None, data_name="y"):
    """Add a GLM to Model ``m``. ``X`` is (n, p) (a 1-d X is one
    predictor); ``y`` is (n,). Returns the obs node id.

    Node names: ``{name}`` (p,) coefficients, ``{name}_0`` intercept
    (if requested), ``{data_name}_eta`` linear predictor, the family's
    nuisance parameters ``{data_name}_sigma`` / ``_nu`` / ``_alpha``.
    ``coef_scale`` overrides the auto prior scales (scalar or (p,))."""
    from exmc_tpu_torch import dists

    X = np.asarray(X, np.float64)
    if X.ndim == 1:
        X = X[:, None]
    y = np.asarray(y, np.float64)
    n, p = X.shape
    if y.shape[0] != n:
        raise ValueError(f"X has {n} rows but y has {y.shape[0]}")
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r} (one of {FAMILIES})")

    # constant columns / constant y fall back to unit scale (a weak
    # prior, not a spike)
    sx = X.std(axis=0)
    sx = np.where(sx > 1e-8, sx, 1.0)
    sy = float(y.std()) if family in ("normal", "robust") else 1.0
    sy = sy if sy > 1e-8 else 1.0
    if coef_scale is None:
        coef_scale = 2.5 * sy / sx
    coef_scale = np.broadcast_to(np.asarray(coef_scale, np.float64), (p,))

    m.rv(name, dists.Normal,
         {"mu": np.zeros(p), "sigma": coef_scale.copy()}, shape=(p,))
    deps = [name]
    if intercept:
        m.rv(f"{name}_0", dists.Normal,
             {"mu": float(y.mean()) if family in ("normal", "robust") else 0.0,
              "sigma": 2.5 * sy})
        deps.append(f"{name}_0")
    m.det(f"{data_name}_eta", LinearPredictor(X.astype(np_dtype())), deps)
    eta = f"{data_name}_eta"

    if family in ("normal", "robust"):
        m.rv(f"{data_name}_sigma", dists.HalfNormal, {"sigma": 2.5 * sy})
        if family == "robust":
            # Juarez-Steel style prior keeps df explorable from
            # near-Cauchy to near-Normal
            m.rv(f"{data_name}_nu", dists.Gamma, {"alpha": 2.0, "beta": 0.1})
            m.rv(data_name, dists.StudentT,
                 {"df": f"{data_name}_nu", "loc": eta,
                  "scale": f"{data_name}_sigma"}, shape=(n,))
        else:
            m.rv(data_name, dists.Normal,
                 {"mu": eta, "sigma": f"{data_name}_sigma"}, shape=(n,))
    elif family == "logistic":
        m.rv(data_name, dists.Bernoulli, {"logits": eta}, shape=(n,))
    elif family == "poisson":
        m.det(f"{data_name}_mu", torch.exp, [eta])
        m.rv(data_name, dists.Poisson, {"mu": f"{data_name}_mu"}, shape=(n,))
    elif family == "negbin":
        m.det(f"{data_name}_mu", torch.exp, [eta])
        m.rv(f"{data_name}_alpha", dists.HalfNormal, {"sigma": 5.0})
        m.rv(data_name, dists.NegativeBinomial,
             {"mu": f"{data_name}_mu", "alpha": f"{data_name}_alpha"}, shape=(n,))
    return m.obs(f"{data_name}_obs", data_name, np.asarray(y, np_dtype()))


def glm_linpred(trace, X, *, name="beta", intercept=True, device=None):
    """Posterior linear predictor at new ``X``: (S, n_new) draws of
    eta = X beta (+ intercept), computed on ``device`` (default
    ``"cuda"``) and returned as a numpy array. Apply the family's
    inverse link yourself (identity / sigmoid / exp)."""
    dev = prepare_device(device)
    X = np.asarray(X)
    if X.ndim == 1:
        X = X[:, None]

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=default_dtype(), device=dev)

    beta = np.asarray(trace[name])
    beta = beta.reshape(-1, beta.shape[-1])
    eta = t(X) @ t(beta).T
    if intercept:
        eta = eta + t(np.asarray(trace[f"{name}_0"]).reshape(-1))[None, :]
    return eta.T.cpu().numpy()
