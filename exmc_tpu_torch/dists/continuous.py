"""Univariate continuous distributions (``exmc_tpu/dists/continuous.py``).
Every scale parameter is floored at 1e-30; a parameter the JAX package
defaults (``loc`` 0, ``scale`` 1, bounds 0 and 1) defaults to a 0-d
tensor here."""

import math

import torch

from exmc_tpu_torch import math as xm
from exmc_tpu_torch.dists import _sampling as rs
from exmc_tpu_torch.dists.base import Distribution, register


def _param(params, key, default, like):
    v = params.get(key)
    return like.new_full((), default) if v is None else v


class Normal(Distribution):
    name = "normal"

    def logpdf(self, x, params):
        mu, sigma = params["mu"], xm.floor_scale(params["sigma"])
        z = (x - mu) / sigma
        return -0.5 * z * z - torch.log(sigma) - xm.LOG_SQRT_2PI

    def sample(self, params, shape, generator):
        return params["mu"] + params["sigma"] * rs.randn(shape, generator)


class Flat(Distribution):
    """Improper uniform over the reals; ``sample`` draws Uniform(-2, 2),
    Stan's unconstrained-init convention."""

    name = "flat"

    def logpdf(self, x, params):
        return torch.zeros_like(x)

    def sample(self, params, shape, generator):
        return 4.0 * rs.rand(shape, generator) - 2.0


class HalfNormal(Distribution):
    name = "half_normal"

    def logpdf(self, x, params):
        sigma = xm.floor_scale(params["sigma"])
        z = x / sigma
        return 0.5 * math.log(2.0 / math.pi) - torch.log(sigma) - 0.5 * z * z

    def support(self, params):
        return "positive"

    def default_transform(self, params):
        return "softplus"

    def sample(self, params, shape, generator):
        return params["sigma"] * torch.abs(rs.randn(shape, generator))


class Exponential(Distribution):
    """Exponential with rate ``lambda``."""

    name = "exponential"

    def logpdf(self, x, params):
        lam = xm.floor_scale(params["lambda"])
        return torch.log(lam) - lam * x

    def support(self, params):
        return "positive"

    def default_transform(self, params):
        return "log"

    def sample(self, params, shape, generator):
        return rs.exponential(shape, generator) / params["lambda"]


class Gamma(Distribution):
    """Gamma(alpha, beta), shape and rate."""

    name = "gamma"

    def logpdf(self, x, params):
        alpha, beta = params["alpha"], xm.floor_scale(params["beta"])
        return (alpha * torch.log(beta) + (alpha - 1.0) * torch.log(x)
                - beta * x - xm.lgamma(alpha))

    def support(self, params):
        return "positive"

    def default_transform(self, params):
        return "log"

    def sample(self, params, shape, generator):
        return rs.gamma(params["alpha"], shape, generator) / params["beta"]


class Beta(Distribution):
    name = "beta"

    def logpdf(self, x, params):
        a, b = params["alpha"], params["beta"]
        return ((a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x)
                - xm.lbeta(a, b))

    def support(self, params):
        return "unit"

    def default_transform(self, params):
        return "logit"

    def sample(self, params, shape, generator):
        shape = rs.full_shape(shape, params["alpha"], params["beta"])
        ga = rs.gamma(params["alpha"], shape, generator)
        gb = rs.gamma(params["beta"], shape, generator)
        return ga / (ga + gb)


class Uniform01(Distribution):
    name = "uniform01"

    def logpdf(self, x, params):
        return torch.zeros_like(x)

    def support(self, params):
        return "unit"

    def default_transform(self, params):
        return "logit"

    def sample(self, params, shape, generator):
        return rs.rand(shape, generator)


class Uniform(Distribution):
    """Uniform(lower, upper): density -log(upper - lower). With constant
    bounds the default transform is ``interval`` (``logit`` on (0, 1))."""

    name = "uniform"

    def logpdf(self, x, params):
        lower = _param(params, "lower", 0.0, x)
        upper = _param(params, "upper", 1.0, x)
        return -torch.log(upper - lower) + torch.zeros_like(x)

    def support(self, params):
        return "interval"

    def default_transform(self, params):
        lower = params.get("lower", 0.0)
        upper = params.get("upper", 1.0)
        if isinstance(lower, (int, float)) and isinstance(upper, (int, float)):
            from exmc_tpu_torch.transforms import IntervalTransform

            if (lower, upper) == (0.0, 1.0):
                return "logit"
            return IntervalTransform(float(lower), float(upper))
        return None

    def sample(self, params, shape, generator):
        lower = params.get("lower", 0.0)
        upper = params.get("upper", 1.0)
        return lower + (upper - lower) * rs.rand(shape, generator)


class StudentT(Distribution):
    """StudentT(df, loc=0, scale=1); ``df`` may be a sampled value."""

    name = "student_t"

    def logpdf(self, x, params):
        df = params["df"]
        loc = params.get("loc", 0.0)
        scale = params.get("scale")
        if scale is None:
            z, log_scale = x - loc, 0.0
        else:
            scale = xm.floor_scale(scale)
            z, log_scale = (x - loc) / scale, torch.log(scale)
        return (
            xm.lgamma((df + 1.0) / 2.0)
            - xm.lgamma(df / 2.0)
            - 0.5 * torch.log(df * math.pi)
            - log_scale
            - (df + 1.0) / 2.0 * torch.log1p(z * z / df)
        )

    def sample(self, params, shape, generator):
        df = params["df"]
        shape = rs.full_shape(shape, df)
        chi2 = 2.0 * rs.gamma(rs.as_tensor(df, generator) / 2.0, shape, generator)
        t = rs.randn(shape, generator) / torch.sqrt(chi2 / df)
        return params.get("loc", 0.0) + params.get("scale", 1.0) * t


class Cauchy(Distribution):
    name = "cauchy"

    def logpdf(self, x, params):
        loc = params.get("loc", 0.0)
        scale = xm.floor_scale(params["scale"])
        z = (x - loc) / scale
        return -torch.log(math.pi * scale) - torch.log1p(z * z)

    def sample(self, params, shape, generator):
        c = torch.tan(math.pi * (rs.rand(shape, generator) - 0.5))
        return params.get("loc", 0.0) + params["scale"] * c


class HalfCauchy(Distribution):
    name = "half_cauchy"

    def logpdf(self, x, params):
        scale = xm.floor_scale(params["scale"])
        z = x / scale
        return math.log(2.0 / math.pi) - torch.log(scale) - torch.log1p(z * z)

    def support(self, params):
        return "positive"

    def default_transform(self, params):
        return "log"

    def sample(self, params, shape, generator):
        c = torch.tan(math.pi * (rs.rand(shape, generator) - 0.5))
        return params["scale"] * torch.abs(c)


class LogNormal(Distribution):
    name = "lognormal"

    def logpdf(self, x, params):
        mu, sigma = params["mu"], xm.floor_scale(params["sigma"])
        lx = torch.log(x)
        z = (lx - mu) / sigma
        return -lx - torch.log(sigma) - xm.LOG_SQRT_2PI - 0.5 * z * z

    def support(self, params):
        return "positive"

    def default_transform(self, params):
        return "log"

    def sample(self, params, shape, generator):
        return torch.exp(params["mu"] + params["sigma"] * rs.randn(shape, generator))


class Laplace(Distribution):
    name = "laplace"

    def logpdf(self, x, params):
        mu, b = params["mu"], xm.floor_scale(params["b"])
        return -torch.log(2.0 * b) - torch.abs(x - mu) / b

    def sample(self, params, shape, generator):
        u = rs.rand(shape, generator) - 0.5
        e = -torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))
        return params["mu"] + params["b"] * e


class TruncatedNormal(Distribution):
    """TruncatedNormal(mu, sigma, lower, upper), normalized by the erf/erfc
    ``ndtr`` (the JAX package's formula)."""

    name = "truncated_normal"

    def logpdf(self, x, params):
        mu, sigma = params["mu"], xm.floor_scale(params["sigma"])
        lower, upper = params["lower"], params["upper"]
        z = (x - mu) / sigma
        base = -0.5 * z * z - torch.log(sigma) - xm.LOG_SQRT_2PI
        a = (lower - mu) / sigma
        b = (upper - mu) / sigma
        return base - torch.log(xm.normal_cdf(b) - xm.normal_cdf(a))

    def sample(self, params, shape, generator):
        mu, sigma = params["mu"], params["sigma"]
        a = rs.as_tensor((params["lower"] - mu) / sigma, generator)
        b = rs.as_tensor((params["upper"] - mu) / sigma, generator)
        shape = rs.full_shape(shape, a, b)
        pa, pb = xm.normal_cdf(a), xm.normal_cdf(b)
        u = pa + (pb - pa) * rs.rand(shape, generator)
        return mu + sigma * torch.clamp(torch.special.ndtri(u), a, b)


class Weibull(Distribution):
    """Weibull(k, lambda), with ``log_survival`` and ``log_cdf`` for
    censored observations."""

    name = "weibull"

    def logpdf(self, t, params):
        k, lam = params["k"], xm.floor_scale(params["lambda"])
        zt = t / lam
        return torch.log(k) - torch.log(lam) + (k - 1.0) * torch.log(zt) - zt ** k

    def log_survival(self, t, params):
        k, lam = params["k"], xm.floor_scale(params["lambda"])
        return -((t / lam) ** k)

    def log_cdf(self, t, params):
        return xm.log1mexp(self.log_survival(t, params))

    def support(self, params):
        return "positive"

    def default_transform(self, params):
        return "log"

    def sample(self, params, shape, generator):
        return params["lambda"] * rs.exponential(shape, generator) ** (1.0 / params["k"])


class InverseGamma(Distribution):
    """InverseGamma(alpha, beta): beta^alpha / Gamma(alpha) x^-(alpha+1)
    e^(-beta/x)."""

    name = "inverse_gamma"

    def logpdf(self, x, params):
        alpha = params["alpha"]
        beta = xm.floor_scale(params["beta"])
        return (alpha * torch.log(beta) - xm.lgamma(alpha)
                - (alpha + 1.0) * torch.log(x) - beta / x)

    def support(self, params):
        return "positive"

    def default_transform(self, params):
        return "log"

    def sample(self, params, shape, generator):
        return params["beta"] / rs.gamma(params["alpha"], shape, generator)


class Gumbel(Distribution):
    """Gumbel(loc, scale): -log(s) - z - exp(-z)."""

    name = "gumbel"

    def logpdf(self, x, params):
        loc = params.get("loc", 0.0)
        scale = xm.floor_scale(_param(params, "scale", 1.0, x))
        z = (x - loc) / scale
        return -torch.log(scale) - z - torch.exp(-z)

    def sample(self, params, shape, generator):
        g = -torch.log(-torch.log(rs.rand(shape, generator)))
        return params.get("loc", 0.0) + params.get("scale", 1.0) * g


NORMAL = register(Normal())
FLAT = register(Flat())
HALF_NORMAL = register(HalfNormal())
EXPONENTIAL = register(Exponential())
GAMMA = register(Gamma())
BETA = register(Beta())
UNIFORM01 = register(Uniform01())
UNIFORM = register(Uniform())
STUDENT_T = register(StudentT())
CAUCHY = register(Cauchy())
HALF_CAUCHY = register(HalfCauchy())
LOGNORMAL = register(LogNormal())
LAPLACE = register(Laplace())
TRUNCATED_NORMAL = register(TruncatedNormal())
WEIBULL = register(Weibull())
INVERSE_GAMMA = register(InverseGamma())
GUMBEL = register(Gumbel())
