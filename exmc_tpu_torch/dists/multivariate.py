"""Multivariate distributions (``exmc_tpu/dists/multivariate.py``):
MvNormal, Dirichlet, Multinomial, ZeroSumNormal, LKJCholesky.

Each acts on the trailing event axes of its value and parameters (see
``base.py``); the leading chain axis and the batch axes broadcast. A
constant covariance is factored once, at compile time
(``prepare_params``); a factor that varies per chain (a sampled
LKJCholesky) is used batched, as (C, ..., d, d).
"""

import torch

from exmc_tpu_torch import math as xm
from exmc_tpu_torch.dists import _sampling as rs
from exmc_tpu_torch.dists.base import Distribution, register


def _log_det_from_chol(chol):
    return 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)


class MvNormal(Distribution):
    """MvNormal(mu, cov) on R^d. ``prepare_params`` turns a constant
    ``cov`` into ``chol`` and ``log_det_cov``; ``chol`` may also be
    given directly (e.g. a sampled Cholesky factor)."""

    name = "mv_normal"
    value_event_dims = 1
    param_event_dims = {"mu": 1, "cov": 2, "chol": 2}

    def prepare_params(self, params):
        if "chol" in params or isinstance(params.get("cov"), str):
            return params
        chol = xm.cholesky_or_nan(params["cov"])
        return {"mu": params["mu"], "chol": chol,
                "log_det_cov": _log_det_from_chol(chol)}

    def logpdf(self, x, params):
        params = self.prepare_params(params)
        mu, chol = params["mu"], params["chol"]
        log_det = params.get("log_det_cov")
        if log_det is None:
            log_det = _log_det_from_chol(chol)
        d = mu.shape[-1]
        diff = x - mu
        if chol.shape[:-2].numel() == 1:
            # one factor for every row: solve all rows as the columns of
            # one right-hand side
            flat = diff.reshape(-1, d)
            w = torch.linalg.solve_triangular(
                chol.reshape(d, d), flat.T, upper=False).T.reshape(diff.shape)
        else:
            shape = torch.broadcast_shapes(diff.shape[:-1], chol.shape[:-2])
            w = torch.linalg.solve_triangular(
                chol.expand(shape + (d, d)),
                diff.expand(shape + (d,)).unsqueeze(-1), upper=False)[..., 0]
        mahal = torch.sum(w * w, dim=-1)
        return -0.5 * (d * xm.LOG_2PI + log_det + mahal)

    def sample(self, params, shape, generator):
        mu = rs.as_tensor(params["mu"], generator)
        chol = (torch.linalg.cholesky(rs.as_tensor(params["cov"], generator))
                if "cov" in params else rs.as_tensor(params["chol"], generator))
        z = rs.randn(tuple(shape) if shape else mu.shape, generator)
        # z L^T row by row, so a batch of factors pairs with a batch of z
        return mu + torch.matmul(z.unsqueeze(-2), chol.transpose(-1, -2)).squeeze(-2)


class Dirichlet(Distribution):
    """Dirichlet(alpha) on the simplex; default transform stick_breaking
    (K constrained -> K-1 unconstrained)."""

    name = "dirichlet"
    value_event_dims = 1
    param_event_dims = {"alpha": 1}

    def logpdf(self, x, params):
        alpha = params["alpha"]
        log_norm = (torch.sum(xm.lgamma(alpha), dim=-1)
                    - xm.lgamma(torch.sum(alpha, dim=-1)))
        return torch.sum((alpha - 1.0) * torch.log(x), dim=-1) - log_norm

    def support(self, params):
        return "simplex"

    def default_transform(self, params):
        return "stick_breaking"

    def sample(self, params, shape, generator):
        alpha = rs.as_tensor(params["alpha"], generator)
        batch = tuple(shape[:-1]) if shape else ()
        g = rs.gamma(alpha, batch + alpha.shape[-1:], generator)
        return g / g.sum(-1, keepdim=True)


class Multinomial(Distribution):
    """Multinomial(n, p) over count vectors along the last axis."""

    name = "multinomial"
    value_event_dims = 1
    param_event_dims = {"p": 1}

    def logpdf(self, y, params):
        p = params["p"]
        n = torch.sum(y, dim=-1)
        eps = torch.finfo(torch.promote_types(p.dtype, torch.float32)).eps
        comb = xm.lgamma(n + 1.0) - torch.sum(xm.lgamma(y + 1.0), dim=-1)
        return comb + torch.sum(y * torch.log(torch.clamp(p, eps, 1.0)), dim=-1)

    def support(self, params):
        return "simplex"

    def default_transform(self, params):
        return "stick_breaking"

    def sample(self, params, shape, generator):
        """Conditional binomials: x_k ~ Binomial(n - sum_{j<k} x_j,
        p_k / sum_{j>=k} p_j)."""
        p = rs.as_tensor(params["p"], generator)
        batch = tuple(shape[:-1]) if shape else ()
        k = p.shape[-1]
        rem_n = rs.as_tensor(params["n"], generator).expand(
            torch.broadcast_shapes(batch, p.shape[:-1]))
        rem_p = torch.ones_like(p[..., 0])
        out = []
        for j in range(k - 1):
            q = torch.clamp(p[..., j] / torch.clamp_min(rem_p, 1e-30), 0.0, 1.0)
            x = rs.binomial(rem_n, q, (), generator)
            out.append(x)
            rem_n = rem_n - x
            rem_p = rem_p - p[..., j]
        out.append(rem_n)
        return torch.stack(out, dim=-1)


class ZeroSumNormal(Distribution):
    """Exchangeable normal with sum(x) = 0 (needs ``shape=(K,)``); default
    transform zero_sum (isometric), so the density on the K-1 free
    coordinates is iid N(0, sigma)."""

    name = "zero_sum_normal"
    value_event_dims = 1

    def logpdf(self, x, params):
        sigma = params.get("sigma")
        sigma = xm.floor_scale(x.new_full((), 1.0) if sigma is None else sigma)
        k = x.shape[-1]
        return (-(k - 1) / 2.0 * (xm.LOG_2PI + 2.0 * torch.log(sigma))
                - 0.5 * torch.sum(x * x, dim=-1) / (sigma * sigma))

    def support(self, params):
        return "zero_sum"

    def default_transform(self, params):
        return "zero_sum"

    def sample(self, params, shape, generator):
        from exmc_tpu_torch.transforms import ZERO_SUM

        if len(shape) == 0:
            raise ValueError("ZeroSumNormal.sample needs shape=(..., K)")
        z = params.get("sigma", 1.0) * rs.randn(
            tuple(shape[:-1]) + (shape[-1] - 1,), generator)
        return ZERO_SUM.forward(z)


class LKJCholesky(Distribution):
    """LKJ prior on the Cholesky factor L of a correlation matrix (needs
    ``shape=(d, d)``; default transform cholesky_corr). Unnormalized:
    sum_i (d - i + 2 eta - 3) log L[i, i], so ``eta`` must be a constant."""

    name = "lkj_cholesky"
    value_event_dims = 2

    def validate_ir_params(self, params):
        if isinstance(params.get("eta"), str):
            raise ValueError(
                "LKJCholesky eta must be a fixed constant, not a sampled "
                "parameter ref: the logpdf drops the eta-dependent "
                "normalizing constant c(eta, d)")

    def logpdf(self, L, params):
        eta = params["eta"]
        d = L.shape[-1]
        diag = torch.diagonal(L, dim1=-2, dim2=-1)
        i = torch.arange(d, dtype=L.dtype, device=L.device)
        coeff = d - i + 2.0 * eta - 3.0
        return torch.sum(coeff * torch.log(torch.clamp_min(diag, 1e-30)), dim=-1)

    def support(self, params):
        return "cholesky_corr"

    def default_transform(self, params):
        return "cholesky_corr"

    def sample(self, params, shape, generator):
        from exmc_tpu_torch.transforms import CHOLESKY_CORR

        if len(shape) < 2 or shape[-1] != shape[-2]:
            raise ValueError("LKJCholesky.sample needs shape=(..., d, d)")
        eta, d, batch = float(params["eta"]), shape[-1], tuple(shape[:-2])
        xs = []
        for i in range(1, d):
            for j in range(i):
                b = eta + (d - j - 2) / 2.0
                ga, gb = rs.gamma(b, batch, generator), rs.gamma(b, batch, generator)
                xs.append(2.0 * ga / (ga + gb) - 1.0)
        x = torch.stack(xs, dim=-1)
        return CHOLESKY_CORR.forward(torch.atanh(torch.clamp(x, -1.0 + 1e-7,
                                                             1.0 - 1e-7)))


MV_NORMAL = register(MvNormal())
DIRICHLET = register(Dirichlet())
MULTINOMIAL = register(Multinomial())
ZERO_SUM_NORMAL = register(ZeroSumNormal())
LKJ_CHOLESKY = register(LKJCholesky())
