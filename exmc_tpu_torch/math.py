"""Differentiable special-function helpers (``exmc_tpu/math.py``)."""

import math

import torch

from exmc_tpu_torch.config import SCALE_FLOOR

LOG_2PI = math.log(2.0 * math.pi)
LOG_SQRT_2PI = 0.5 * LOG_2PI
HALF_SQRT_2 = 0.5 * math.sqrt(2.0)


def lgamma(x):
    """log|Gamma(x)|; its gradient is digamma(x), as for JAX's gammaln."""
    return torch.lgamma(x)


def lbeta(a, b):
    """log B(a, b) = lgamma(a) + lgamma(b) - lgamma(a + b)."""
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def ndtr(x):
    """Standard normal CDF in the formula of ``jax.scipy.special.ndtr``:
    erf near 0, erfc in both tails, so the lower tail keeps its relative
    precision in float32 (``0.5 * (1 + erf(x / sqrt 2))`` loses it)."""
    w = x * HALF_SQRT_2
    z = torch.abs(w)
    y = torch.where(z < HALF_SQRT_2, 1.0 + torch.erf(w),
                    torch.where(w > 0.0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def normal_cdf(z):
    """Phi(z); the erf/erfc ``ndtr`` above (``torch.special.ndtr`` loses
    the lower tail in float32)."""
    return ndtr(z)


def log_normal_cdf(z):
    """log Phi(z), stable in the deep lower tail."""
    return torch.special.log_ndtr(z)


def log_normal_sf(z):
    """log(1 - Phi(z)) = log Phi(-z)."""
    return torch.special.log_ndtr(-z)


def floor_scale(sigma):
    """Floor scale params at 1e-30 so a bad warmup point never divides
    by zero."""
    return torch.clamp_min(sigma, SCALE_FLOOR)


def event_sum(x):
    """Sum over every axis but the leading chain axis: (C, *event) -> (C,).

    This is where the JAX package's all-axes ``jnp.sum`` of one point
    becomes a per-chain sum, so chains never mix. A tensor with no
    event axes comes back as it is (``torch.sum(x, dim=())`` would sum
    everything)."""
    if x.ndim <= 1:
        return x
    return x.flatten(1).sum(1)


def logsumexp(x, dim):
    return torch.logsumexp(x, dim=dim)


def logit(p):
    return torch.log(p) - torch.log1p(-p)


def log1mexp(x):
    """log(1 - exp(x)) for x <= 0, numerically stable."""
    return torch.where(
        x > -math.log(2.0),
        torch.log(-torch.expm1(x)),
        torch.log1p(-torch.exp(x)),
    )


def softplus(x):
    """log(1 + exp(x)) as logaddexp(x, 0), the JAX package's formula."""
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y):
    """Inverse of softplus: log(expm1(y)) = y + log(1 - exp(-y))."""
    return y + log1mexp(-y)


def const_like(array):
    """A numpy array that a det callable closes over, as a tensor on the
    device and in the dtype of the point it is applied to: ``get(like)``
    makes the copy once per (dtype, device), at the first (eager) call,
    never inside a CUDA graph capture. The copy is made outside any
    ``torch.func`` transform the call runs under, so the cached tensor
    is a plain one that later calls can use."""
    cache = {}

    def get(like):
        key = (like.dtype, like.device)
        if key not in cache:
            with torch._C._DisableFuncTorch():
                cache[key] = torch.as_tensor(array, dtype=like.dtype, device=like.device)
        return cache[key]

    return get


def cholesky_or_nan(a):
    """Lower Cholesky factor of each (..., n, n) matrix, NaN where the
    matrix is not positive definite: what ``jnp.linalg.cholesky``
    returns, where ``torch.linalg.cholesky`` raises. A sampled
    covariance that is not positive definite then makes a NaN
    log-density (a divergent leaf), not an error."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], chol, torch.full_like(chol, math.nan))
