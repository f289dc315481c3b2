"""The 45 gold standards of the JAX package's expanded zoo
(``exmc_tpu/benchmarks/gold_models.py``), built with the port's
``Builder`` (the five ``stan_*`` through the port's ``stan.compile``)
from the same seeds and data.

Each target is exact, by the JAX module's own means: conjugate
posteriors, dense-grid quadrature of a scalar posterior, the Kalman/RTS
smoother of a Gaussian random walk, closed-form LKJ and order-statistic
moments. Eight targets come from marginalized Laplace fits with 400k-draw
importance sampling or dense multi-dimensional grids (radon, kidiq,
the crossed LMM, the AV-TEST GLMM, the two Kilpisjärvi models,
diabetes and the d=21 Stan logistic regression); those are stored here
as constants (``HEAVY_TARGETS``), equal to the JAX module's values
(``tests/test_torch_golds.py``).

Callable det nodes receive batched, aligned torch tensors with the chain
axis first (``compiler.py``): an index goes through the ``getitem`` det
op (the first event axis), and constant arrays are det arguments, moved
to the device once at compile time.
"""

import math

import numpy as np
import torch
from scipy.special import gammaln, log_ndtr, ndtr

from exmc_tpu_torch import Builder, dists, stan
from exmc_tpu_torch.benchmarks.validation import GoldStandard
from exmc_tpu_torch.datasets import load_csv, load_diabetes, load_kilpisjarvi


# ---------------------------------------------------------------------------
# exact-target machinery
# ---------------------------------------------------------------------------

def quadrature_posterior(log_post_fn, lo, hi, n=100001):
    """Scalar posterior mean and sd by dense-grid trapezoid quadrature of
    a vectorized float64 unnormalized log posterior."""
    th = np.linspace(lo, hi, n, dtype=np.float64)
    lp = np.asarray(log_post_fn(th), dtype=np.float64)
    w = np.exp(lp - lp.max())
    z = np.trapezoid(w, th)
    mean = np.trapezoid(w * th, th) / z
    var = np.trapezoid(w * (th - mean) ** 2, th) / z
    return float(mean), float(math.sqrt(var))


def kalman_smoother_grw(ys, q, r):
    """Marginal posterior means/sds of the latent path of
    x_1 ~ N(0, q^2); x_t ~ N(x_{t-1}, q^2); y_t ~ N(x_t, r^2), by the RTS
    smoother in float64."""
    T = len(ys)
    m_f, p_f = np.zeros(T), np.zeros(T)
    m_pred, p_pred = np.zeros(T), np.zeros(T)
    m, p = 0.0, 0.0
    for t in range(T):
        mp, pp = m, p + q * q
        m_pred[t], p_pred[t] = mp, pp
        k = pp / (pp + r * r)
        m = mp + k * (ys[t] - mp)
        p = (1.0 - k) * pp
        m_f[t], p_f[t] = m, p
    m_s, p_s = np.zeros(T), np.zeros(T)
    m_s[-1], p_s[-1] = m_f[-1], p_f[-1]
    for t in range(T - 2, -1, -1):
        c = p_f[t] / p_pred[t + 1]
        m_s[t] = m_f[t] + c * (m_s[t + 1] - m_pred[t + 1])
        p_s[t] = p_f[t] + c * c * (p_s[t + 1] - p_pred[t + 1])
    return m_s, np.sqrt(p_s)


def _normal_lp(y, mu, sigma):
    z = (np.asarray(y)[..., None] - mu) / sigma
    return -0.5 * z * z - math.log(sigma) - 0.5 * math.log(2 * math.pi)


def _heavy(name, ir, **kw):
    t = HEAVY_TARGETS[name]
    means = {k: np.asarray(v) if isinstance(v, list) else v
             for k, v in t["means"].items()}
    sds = {k: np.asarray(v) if isinstance(v, list) else v
           for k, v in t["sds"].items()}
    return GoldStandard(name, ir, means, sds, **kw)


# ---------------------------------------------------------------------------
# conjugate / analytic targets
# ---------------------------------------------------------------------------

def exponential_gamma(seed=10):
    rng = np.random.default_rng(seed)
    n, lam_true, a0, b0 = 60, 2.0, 2.0, 1.0
    ys = rng.exponential(1.0 / lam_true, size=n)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "lam", dists.Gamma, {"alpha": a0, "beta": b0})
    ir = Builder.rv(ir, "y", dists.Exponential, {"lambda": "lam"})
    ir = Builder.obs(ir, "y_obs", "y", ys)
    a, b = a0 + n, b0 + ys.sum()
    return GoldStandard("exponential_gamma", ir, {"lam": a / b},
                        {"lam": math.sqrt(a) / b})


def lognormal_conjugate(seed=11):
    rng = np.random.default_rng(seed)
    n, mu_true, sigma, prior_sd = 40, 0.8, 0.5, 5.0
    ys = rng.lognormal(mu_true, sigma, size=n)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": prior_sd})
    ir = Builder.rv(ir, "y", dists.LogNormal, {"mu": "mu", "sigma": sigma})
    ir = Builder.obs(ir, "y_obs", "y", ys)
    post_var = 1.0 / (1.0 / prior_sd**2 + n / sigma**2)
    post_mean = post_var * np.log(ys).sum() / sigma**2
    return GoldStandard("lognormal_conjugate", ir, {"mu": post_mean},
                        {"mu": math.sqrt(post_var)})


def uniform01_bernoulli(seed=12):
    rng = np.random.default_rng(seed)
    n, p_true = 120, 0.65
    ys = (rng.random(n) < p_true).astype(np.float64)
    k = ys.sum()
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "p", dists.Uniform01, {})
    ir = Builder.rv(ir, "y", dists.Bernoulli, {"p": "p"})
    ir = Builder.obs(ir, "y_obs", "y", ys)
    a, b = 1.0 + k, 1.0 + n - k
    return GoldStandard("uniform01_bernoulli", ir, {"p": a / (a + b)},
                        {"p": math.sqrt(a * b / ((a + b) ** 2 * (a + b + 1)))})


def custom_gaussian_conjugate(seed=13):
    """A Custom dist with a hand-written torch Gaussian logpdf."""
    rng = np.random.default_rng(seed)
    n, mu_true, sigma, prior_sd = 50, -1.0, 1.0, 8.0
    ys = rng.normal(mu_true, sigma, size=n)
    gauss = dists.Custom(
        logpdf_fn=lambda x, params: -0.5 * ((x - params["loc"]) / sigma) ** 2
        - math.log(sigma) - 0.5 * math.log(2 * math.pi),
        support="real",
    )
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": prior_sd})
    ir = Builder.rv(ir, "y", gauss, {"loc": "mu"})
    ir = Builder.obs(ir, "y_obs", "y", ys)
    post_var = 1.0 / (1.0 / prior_sd**2 + n / sigma**2)
    post_mean = post_var * ys.sum() / sigma**2
    return GoldStandard("custom_gaussian_conjugate", ir, {"mu": post_mean},
                        {"mu": math.sqrt(post_var)})


def dirichlet_prior_moments():
    """Dirichlet prior, no data: the stick-breaking K -> K-1 transform."""
    alpha = np.array([2.0, 3.0, 4.0])
    a0 = alpha.sum()
    mean = alpha / a0
    sd = np.sqrt(alpha * (a0 - alpha) / (a0**2 * (a0 + 1.0)))
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "w", dists.Dirichlet, {"alpha": alpha}, shape=(3,))
    return GoldStandard("dirichlet_prior", ir, {"w": mean}, {"w": sd})


def mvn_dense_mass():
    """rho = 0.95, d = 4 MvNormal prior sampled with the dense metric."""
    d, rho = 4, 0.95
    cov = rho * np.ones((d, d)) + (1 - rho) * np.eye(d)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "x", dists.MvNormal, {"mu": np.zeros(d), "cov": cov})
    return GoldStandard("mvn_dense_mass", ir, {"x": np.zeros(d)},
                        {"x": np.sqrt(np.diag(cov))}, opts={"dense_mass": True})


def linreg_meas_obs_matmul(seed=14):
    """meas_obs through a matmul lift: y = A x observed."""
    rng = np.random.default_rng(seed)
    d, prior_sd = 3, 10.0
    a = np.array([[2.0, 0.3, 0.0], [0.1, 1.5, 0.2], [0.0, 0.4, 1.2]])
    x_true = rng.normal(0.7, 1.0, size=d)
    y = a @ x_true
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": prior_sd})
    ir = Builder.rv(ir, "x", dists.Normal, {"mu": "mu", "sigma": 1.0}, shape=(d,))
    ir = Builder.det(ir, "yd", "matmul", [a, "x"])
    ir = Builder.obs(ir, "y_obs", "yd", y)
    post_var = 1.0 / (1.0 / prior_sd**2 + d)
    post_mean = post_var * np.linalg.solve(a, y).sum()
    return GoldStandard("linreg_meas_obs_matmul", ir, {"mu": post_mean},
                        {"mu": math.sqrt(post_var)})


def affine_meas_obs(seed=15):
    """meas_obs through an affine lift: y = a x + b observed."""
    a_c, b_c, prior_sd = 2.5, -1.0, 10.0
    y = 4.0
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": prior_sd})
    ir = Builder.rv(ir, "x", dists.Normal, {"mu": "mu", "sigma": 1.0})
    ir = Builder.det(ir, "yd", "affine", [a_c, b_c, "x"])
    ir = Builder.obs(ir, "y_obs", "yd", y)
    post_var = 1.0 / (1.0 / prior_sd**2 + 1.0)
    return GoldStandard("affine_meas_obs", ir,
                        {"mu": post_var * (y - b_c) / a_c},
                        {"mu": math.sqrt(post_var)})


# ---------------------------------------------------------------------------
# quadrature-exact targets (non-conjugate scalar-parameter models)
# ---------------------------------------------------------------------------

def studentt_loc(seed=20):
    rng = np.random.default_rng(seed)
    n, df, loc_true = 40, 4.0, 1.2
    ys = loc_true + rng.standard_t(df, size=n)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = Builder.rv(ir, "y", dists.StudentT, {"df": df, "loc": "mu", "scale": 1.0})
    ir = Builder.obs(ir, "y_obs", "y", ys)

    def log_post(mu):
        z = ys[:, None] - mu[None, :]
        return (-(df + 1) / 2 * np.log1p(z * z / df)).sum(0) - 0.5 * (mu / 5.0) ** 2

    mean, sd = quadrature_posterior(log_post, -3.0, 6.0)
    return GoldStandard("studentt_loc", ir, {"mu": mean}, {"mu": sd})


def cauchy_loc(seed=21):
    rng = np.random.default_rng(seed)
    n, loc_true = 30, -0.5
    ys = loc_true + rng.standard_cauchy(size=n)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = Builder.rv(ir, "y", dists.Cauchy, {"loc": "mu", "scale": 1.0})
    ir = Builder.obs(ir, "y_obs", "y", ys)

    def log_post(mu):
        z = ys[:, None] - mu[None, :]
        return -np.log1p(z * z).sum(0) - 0.5 * (mu / 5.0) ** 2

    mean, sd = quadrature_posterior(log_post, -5.0, 4.0)
    return GoldStandard("cauchy_loc", ir, {"mu": mean}, {"mu": sd})


def laplace_loc(seed=22):
    rng = np.random.default_rng(seed)
    n, loc_true = 50, 0.7
    ys = rng.laplace(loc_true, 1.0, size=n)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = Builder.rv(ir, "y", dists.Laplace, {"mu": "mu", "b": 1.0})
    ir = Builder.obs(ir, "y_obs", "y", ys)

    def log_post(mu):
        return -np.abs(ys[:, None] - mu[None, :]).sum(0) - 0.5 * (mu / 5.0) ** 2

    mean, sd = quadrature_posterior(log_post, -3.0, 4.0)
    return GoldStandard("laplace_loc", ir, {"mu": mean}, {"mu": sd})


def weibull_rate(seed=23):
    rng = np.random.default_rng(seed)
    n, k, lam_true, a0, b0 = 60, 1.5, 2.0, 2.0, 1.0
    ys = lam_true * rng.weibull(k, size=n)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "lam", dists.Gamma, {"alpha": a0, "beta": b0})
    ir = Builder.rv(ir, "y", dists.Weibull, {"k": k, "lambda": "lam"})
    ir = Builder.obs(ir, "y_obs", "y", ys)

    def log_post(lam):
        zt = ys[:, None] / lam[None, :]
        lik = (k - 1) * np.log(zt) - np.log(lam)[None, :] - zt**k
        return lik.sum(0) + (a0 - 1) * np.log(lam) - b0 * lam

    mean, sd = quadrature_posterior(log_post, 1e-3, 6.0)
    return GoldStandard("weibull_rate", ir, {"lam": mean}, {"lam": sd})


def halfnormal_scale(seed=24):
    rng = np.random.default_rng(seed)
    n, sigma_true = 50, 1.3
    ys = rng.normal(0.0, sigma_true, size=n)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "sigma", dists.HalfNormal, {"sigma": 3.0})
    ir = Builder.rv(ir, "y", dists.Normal, {"mu": 0.0, "sigma": "sigma"})
    ir = Builder.obs(ir, "y_obs", "y", ys)
    ss = float((ys**2).sum())

    def log_post(s):
        return (-n * np.log(s) - ss / (2 * s * s)) - 0.5 * (s / 3.0) ** 2

    mean, sd = quadrature_posterior(log_post, 1e-3, 5.0)
    return GoldStandard("halfnormal_scale", ir, {"sigma": mean}, {"sigma": sd})


def truncnorm_loc(seed=25):
    rng = np.random.default_rng(seed)
    n, mu_true, lo, hi = 60, 0.8, -1.0, 3.0
    raw = rng.normal(mu_true, 1.0, size=4 * n)
    ys = raw[(raw > lo) & (raw < hi)][:n]
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = Builder.rv(ir, "y", dists.TruncatedNormal,
                    {"mu": "mu", "sigma": 1.0, "lower": lo, "upper": hi})
    ir = Builder.obs(ir, "y_obs", "y", ys)

    def log_post(mu):
        z = ys[:, None] - mu[None, :]
        log_norm = np.log(ndtr(hi - mu) - ndtr(lo - mu))
        return (-0.5 * z * z).sum(0) - n * log_norm - 0.5 * (mu / 5.0) ** 2

    mean, sd = quadrature_posterior(log_post, -2.0, 4.0)
    return GoldStandard("truncnorm_loc", ir, {"mu": mean}, {"mu": sd})


def uniform_interval_normal(seed=26):
    """Uniform(2, 5) prior (the interval transform) + Normal likelihood."""
    rng = np.random.default_rng(seed)
    n, theta_true = 15, 2.6
    ys = rng.normal(theta_true, 1.0, size=n)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "theta", dists.Uniform, {"lower": 2.0, "upper": 5.0})
    ir = Builder.rv(ir, "y", dists.Normal, {"mu": "theta", "sigma": 1.0})
    ir = Builder.obs(ir, "y_obs", "y", ys)

    def log_post(th):
        z = ys[:, None] - th[None, :]
        return (-0.5 * z * z).sum(0)

    mean, sd = quadrature_posterior(log_post, 2.0 + 1e-9, 5.0 - 1e-9)
    return GoldStandard("uniform_interval_normal", ir, {"theta": mean},
                        {"theta": sd})


def mixture_loc(seed=27):
    """Known-weight two-component Normal mixture, one unknown mean."""
    rng = np.random.default_rng(seed)
    ys = np.concatenate([rng.normal(-2.0, 0.5, 50), rng.normal(3.0, 0.5, 50)])
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "m1", dists.Normal, {"mu": 2.0, "sigma": 5.0})
    ir = Builder.rv(ir, "y", dists.Mixture, {
        "components": [dists.Normal, dists.Normal],
        "params": [{"mu": -2.0, "sigma": 0.5}, {"mu": "m1", "sigma": 0.5}],
        "weights": np.array([0.5, 0.5]),
    })
    ir = Builder.obs(ir, "y_obs", "y", ys)

    def log_post(m):
        lp1 = _normal_lp(ys, -2.0, 0.5) + math.log(0.5)
        lp2 = (-0.5 * ((ys[:, None] - m[None, :]) / 0.5) ** 2
               - math.log(0.5) - 0.5 * math.log(2 * math.pi) + math.log(0.5))
        mx = np.maximum(lp1, lp2)
        lik = mx + np.log(np.exp(lp1 - mx) + np.exp(lp2 - mx))
        return lik.sum(0) - 0.5 * ((m - 2.0) / 5.0) ** 2

    mean, sd = quadrature_posterior(log_post, 1.0, 5.0)
    return GoldStandard("mixture_loc", ir, {"m1": mean}, {"m1": sd})


def censored_right_normal(seed=28):
    rng = np.random.default_rng(seed)
    n, mu_true, cut = 60, 1.0, 1.5
    raw = rng.normal(mu_true, 1.0, size=n)
    observed = raw[raw <= cut]
    n_cens = int((raw > cut).sum())
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": 10.0})
    ir = Builder.rv(ir, "y", dists.Normal, {"mu": "mu", "sigma": 1.0})
    ir = Builder.obs(ir, "y_obs", "y", observed)
    ir = Builder.rv(ir, "y_c", dists.Normal, {"mu": "mu", "sigma": 1.0})
    ir = Builder.obs(ir, "y_c_obs", "y_c", np.full(n_cens, cut), censored="right")

    def log_post(mu):
        z = observed[:, None] - mu[None, :]
        lik = (-0.5 * z * z).sum(0) + n_cens * log_ndtr(-(cut - mu))
        return lik - 0.5 * (mu / 10.0) ** 2

    mean, sd = quadrature_posterior(log_post, -1.0, 3.5)
    return GoldStandard("censored_right_normal", ir, {"mu": mean}, {"mu": sd})


def censored_interval_normal(seed=29):
    rng = np.random.default_rng(seed)
    n_exact, n_int, mu_true = 40, 30, 0.5
    ys = rng.normal(mu_true, 1.0, size=n_exact)
    lo_i, hi_i = -0.5, 1.5
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": 10.0})
    ir = Builder.rv(ir, "y", dists.Normal, {"mu": "mu", "sigma": 1.0})
    ir = Builder.obs(ir, "y_obs", "y", ys)
    ir = Builder.rv(ir, "y_i", dists.Normal, {"mu": "mu", "sigma": 1.0})
    ir = Builder.obs(ir, "y_i_obs", "y_i",
                     {"lower": np.full(n_int, lo_i), "upper": np.full(n_int, hi_i)},
                     censored="interval")

    def log_post(mu):
        z = ys[:, None] - mu[None, :]
        lik = (-0.5 * z * z).sum(0) + n_int * np.log(ndtr(hi_i - mu) - ndtr(lo_i - mu))
        return lik - 0.5 * (mu / 10.0) ** 2

    mean, sd = quadrature_posterior(log_post, -1.5, 2.5)
    return GoldStandard("censored_interval_normal", ir, {"mu": mean}, {"mu": sd})


def poisson_log_link(seed=30):
    """Poisson regression with a log link through a callable det node."""
    rng = np.random.default_rng(seed)
    n, beta_true = 80, 0.6
    x = rng.normal(0.0, 1.0, size=n)
    ys = rng.poisson(np.exp(beta_true * x)).astype(np.float64)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "beta", dists.Normal, {"mu": 0.0, "sigma": 2.5})
    ir = Builder.det(ir, "rate", lambda b, xx: torch.exp(b * xx), ["beta", x])
    ir = Builder.rv(ir, "y", dists.Poisson, {"mu": "rate"}, shape=(n,))
    ir = Builder.obs(ir, "y_obs", "y", ys)

    def log_post(beta):
        eta = x[:, None] * beta[None, :]
        lik = ys[:, None] * eta - np.exp(eta) - gammaln(ys + 1.0)[:, None]
        return lik.sum(0) - 0.5 * (beta / 2.5) ** 2

    mean, sd = quadrature_posterior(log_post, -0.5, 1.5)
    return GoldStandard("poisson_log_link", ir, {"beta": mean}, {"beta": sd})


def grw_kalman_t1000(seed=31):
    """GaussianRandomWalk latent path, T = 1000, Normal observations at
    every step; exact marginals from the RTS smoother."""
    rng = np.random.default_rng(seed)
    T, q, r = 1000, 0.1, 0.5
    x_true = np.cumsum(rng.normal(0.0, q, size=T))
    ys = x_true + rng.normal(0.0, r, size=T)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "x", dists.GaussianRandomWalk, {"sigma": q}, shape=(T,))
    ir = Builder.rv(ir, "y", dists.Normal, {"mu": "x", "sigma": r}, shape=(T,))
    ir = Builder.obs(ir, "y_obs", "y", ys)
    m_s, sd_s = kalman_smoother_grw(ys, q, r)
    return GoldStandard("grw_kalman_t1000", ir, {"x": m_s}, {"x": sd_s},
                        opts={"num_warmup": 800, "num_samples": 800})


# ---------------------------------------------------------------------------
# multilevel and regression models with stored targets
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Stan-frontend-built models
# ---------------------------------------------------------------------------

EIGHT_SCHOOLS_DATA = {
    "J": 8,
    "y": np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]),
    "sigma": np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]),
}

STAN_EIGHT_SCHOOLS = """
    data { int J; vector[J] y; vector[J] sigma; }
    parameters { real mu; real<lower=0> tau; vector[J] theta; }
    model {
      mu ~ normal(0, 5);
      tau ~ half_cauchy(5);
      theta ~ normal(mu, tau);
      y ~ normal(theta, sigma);
    }
    """

STAN_EIGHT_SCHOOLS_NCP = """
    data { int J; vector[J] y; vector[J] sigma; }
    parameters { real mu; real<lower=0> tau; vector[J] theta_raw; }
    transformed parameters { vector[J] theta = mu + tau * theta_raw; }
    model {
      mu ~ normal(0, 5);
      tau ~ half_cauchy(5);
      theta_raw ~ normal(0, 1);
      y ~ normal(theta, sigma);
    }
    """

STAN_LOGISTIC = """
    data { int N; int K; matrix[N, K] X; vector[N] y; }
    parameters { vector[K] beta; }
    model {
      beta ~ normal(0, 2.5);
      y ~ bernoulli(sigmoid(X * beta));
    }
    """


def stan_eight_schools():
    """Eight schools built through the Stan frontend (vector params +
    data); published posterior moments."""
    ir = stan.compile(STAN_EIGHT_SCHOOLS, EIGHT_SCHOOLS_DATA)
    return GoldStandard(
        "stan_eight_schools", ir,
        {"mu": 4.4, "tau": 3.6}, {"mu": 3.3, "tau": 3.2}, ncp=True,
    )


def stan_uniform_normal(seed=32):
    """The target of uniform_interval_normal, built via Stan syntax
    'theta ~ uniform(2, 5)'."""
    rng = np.random.default_rng(seed)
    n, theta_true = 15, 2.6
    ys = rng.normal(theta_true, 1.0, size=n)
    code = """
    data { vector[15] y; }
    parameters { real theta; }
    model {
      theta ~ uniform(2, 5);
      y ~ normal(theta, 1);
    }
    """
    ir = stan.compile(code, {"y": ys})

    def log_post(th):
        z = ys[:, None] - th[None, :]
        return (-0.5 * z * z).sum(0)

    mean, sd = quadrature_posterior(log_post, 2.0 + 1e-9, 5.0 - 1e-9)
    return GoldStandard("stan_uniform_normal", ir, {"theta": mean},
                        {"theta": sd})


def stan_logistic_1d(seed=33):
    """1-coefficient logistic regression via the Stan frontend's
    expression grammar (sigmoid + arithmetic); quadrature exact."""
    rng = np.random.default_rng(seed)
    n, beta_true = 100, 1.2
    x = rng.normal(0.0, 1.0, size=n)
    p = 1.0 / (1.0 + np.exp(-beta_true * x))
    ys = (rng.random(n) < p).astype(np.float64)
    code = """
    data { vector[100] x; vector[100] y; }
    parameters { real beta; }
    model {
      beta ~ normal(0, 2.5);
      y ~ bernoulli(sigmoid(beta * x));
    }
    """
    ir = stan.compile(code, {"x": x, "y": ys})

    def log_post(beta):
        eta = x[:, None] * beta[None, :]
        lik = ys[:, None] * eta - np.log1p(np.exp(eta))
        return lik.sum(0) - 0.5 * (beta / 2.5) ** 2

    mean, sd = quadrature_posterior(log_post, -1.0, 4.0)
    return GoldStandard("stan_logistic_1d", ir, {"beta": mean},
                        {"beta": sd})


def stan_eight_schools_ncp():
    """Eight schools in Stan NCP syntax, transformed parameters
    ``theta = mu + tau * theta_raw``; published posterior moments. The
    program is the NCP: no auto-NCP rewrite on top."""
    ir = stan.compile(STAN_EIGHT_SCHOOLS_NCP, EIGHT_SCHOOLS_DATA)
    return GoldStandard(
        "stan_eight_schools_ncp", ir,
        {"mu": 4.4, "tau": 3.6}, {"mu": 3.3, "tau": 3.2}, ncp=False,
    )


def stan_logistic_d21_data(seed=35):
    """The d=21 logistic regression's data: X (500, 21), y (500,)."""
    rng = np.random.default_rng(seed)
    n, k = 500, 21
    x = rng.normal(size=(n, k)).astype(np.float64)
    beta_true = rng.normal(0.0, 0.5, size=k)
    p = 1.0 / (1.0 + np.exp(-(x @ beta_true)))
    y = (rng.random(n) < p).astype(np.float64)
    return {"N": n, "K": k, "X": x.astype(np.float32), "y": y.astype(np.float32)}


def stan_logistic_d21(seed=35):
    """d=21 logistic regression (the reference's headline GLM scale)
    built via the Stan frontend's matrix syntax; its target (Laplace +
    400k-draw importance sampling in the JAX module) is stored in
    ``HEAVY_TARGETS``."""
    ir = stan.compile(STAN_LOGISTIC, stan_logistic_d21_data(seed))
    return _heavy("stan_logistic_d21", ir)


def radon_varying_intercept(seed=40, n_counties=85, n_homes=919):
    """Radon-style varying-intercept multilevel model (d = 89):
    mu_a ~ N(0, 10); sigma_a ~ HalfNormal(1); alpha_j ~ N(mu_a, sigma_a)
    (auto-NCP); beta ~ N(0, 10); sigma_y ~ HalfNormal(1);
    y_i ~ N(alpha[county_i] + beta floor_i, sigma_y). Target: the JAX
    module's (alphas marginalized analytically, Laplace-IS on the 4-d
    hyperparameter marginal)."""
    rng = np.random.default_rng(seed)
    raw = rng.pareto(1.1, size=n_counties) + 1.0
    sizes = np.maximum(1, (raw / raw.sum() * n_homes).astype(int))
    while sizes.sum() < n_homes:
        sizes[rng.integers(n_counties)] += 1
    while sizes.sum() > n_homes:
        j = rng.integers(n_counties)
        if sizes[j] > 1:
            sizes[j] -= 1
    county = np.repeat(np.arange(n_counties), sizes)
    floor_x = (rng.random(n_homes) < 0.45).astype(np.float64)
    true_alpha = rng.normal(1.46, 0.33, size=n_counties)
    y = rng.normal(true_alpha[county] - 0.69 * floor_x, 0.76)

    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu_a", dists.Normal, {"mu": 0.0, "sigma": 10.0})
    ir = Builder.rv(ir, "sigma_a", dists.HalfNormal, {"sigma": 1.0})
    ir = Builder.rv(ir, "alpha", dists.Normal,
                    {"mu": "mu_a", "sigma": "sigma_a"}, shape=(n_counties,))
    ir = Builder.rv(ir, "beta", dists.Normal, {"mu": 0.0, "sigma": 10.0})
    ir = Builder.rv(ir, "sigma_y", dists.HalfNormal, {"sigma": 1.0})
    ir = Builder.det(ir, "alpha_county", "getitem", ["alpha", county])
    ir = Builder.det(ir, "mu_y", lambda a, b, f: a + b * f,
                     ["alpha_county", "beta", floor_x.astype(np.float32)])
    ir = Builder.rv(ir, "y", dists.Normal,
                    {"mu": "mu_y", "sigma": "sigma_y"}, shape=(n_homes,))
    ir = Builder.obs(ir, "y_obs", "y", y.astype(np.float32))
    return _heavy("radon_varying_intercept", ir, ncp=True)


def kidiq_regression(seed=41, n=434):
    """kidiq-style linear regression, d = 4 with an unknown scale; target
    the JAX module's (Laplace-IS)."""
    rng = np.random.default_rng(seed)
    mom_hs = (rng.random(n) < 0.785).astype(np.float64)
    mom_iq = rng.normal(100.0, 15.0, size=n)
    y = rng.normal(26.0 + 6.0 * mom_hs + 0.56 * mom_iq, 18.0)
    iq_c = mom_iq - mom_iq.mean()

    ir = Builder.new_ir()
    ir = Builder.rv(ir, "b0", dists.Normal, {"mu": 0.0, "sigma": 100.0})
    ir = Builder.rv(ir, "b_hs", dists.Normal, {"mu": 0.0, "sigma": 10.0})
    ir = Builder.rv(ir, "b_iq", dists.Normal, {"mu": 0.0, "sigma": 10.0})
    ir = Builder.rv(ir, "sigma", dists.HalfNormal, {"sigma": 20.0})
    ir = Builder.det(ir, "mu_y", lambda b0, b1, b2, hs, iq: b0 + b1 * hs + b2 * iq,
                     ["b0", "b_hs", "b_iq", mom_hs.astype(np.float32),
                      iq_c.astype(np.float32)])
    ir = Builder.rv(ir, "y", dists.Normal,
                    {"mu": "mu_y", "sigma": "sigma"}, shape=(n,))
    ir = Builder.obs(ir, "y_obs", "y", y.astype(np.float32))
    return _heavy("kidiq_regression", ir)


# ---------------------------------------------------------------------------
# funnel, flat prior, discrete likelihoods, constrained supports
# ---------------------------------------------------------------------------

def funnel_v_marginal():
    """Neal's funnel under auto-NCP: v's marginal is its N(0, 3) prior."""
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "v", dists.Normal, {"mu": 0.0, "sigma": 3.0})
    ir = Builder.det(ir, "scale", lambda v: torch.exp(v / 2.0), ["v"])
    ir = Builder.rv(ir, "x", dists.Normal, {"mu": 0.0, "sigma": "scale"}, shape=(9,))
    return GoldStandard("funnel_v_marginal", ir, {"v": 0.0}, {"v": 3.0}, ncp=True)


def flat_prior_normal(seed=33):
    rng = np.random.default_rng(seed)
    n, mu_true, sigma = 50, 1.7, 2.0
    ys = rng.normal(mu_true, sigma, size=n)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Flat, {})
    ir = Builder.rv(ir, "y", dists.Normal, {"mu": "mu", "sigma": sigma})
    ir = Builder.obs(ir, "y_obs", "y", ys)
    return GoldStandard("flat_prior_normal", ir, {"mu": float(ys.mean())},
                        {"mu": sigma / math.sqrt(n)})


def binomial_beta(seed=34):
    rng = np.random.default_rng(seed)
    groups, trials, p_true, a0, b0 = 30, 20, 0.35, 2.0, 2.0
    ys = rng.binomial(trials, p_true, size=groups).astype(float)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "p", dists.Beta, {"alpha": a0, "beta": b0})
    ir = Builder.rv(ir, "y", dists.Binomial, {"n": float(trials), "p": "p"})
    ir = Builder.obs(ir, "y_obs", "y", ys)
    a = a0 + ys.sum()
    b = b0 + groups * trials - ys.sum()
    return GoldStandard("binomial_beta", ir, {"p": a / (a + b)},
                        {"p": math.sqrt(a * b / ((a + b) ** 2 * (a + b + 1.0)))})


def negbin_rate(seed=35):
    rng = np.random.default_rng(seed)
    n, mu_true, alpha = 50, 4.0, 3.0
    lam = rng.gamma(alpha, mu_true / alpha, size=n)
    ys = rng.poisson(lam).astype(float)
    a0, b0 = 2.0, 0.5
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Gamma, {"alpha": a0, "beta": b0})
    ir = Builder.rv(ir, "y", dists.NegativeBinomial, {"mu": "mu", "alpha": alpha})
    ir = Builder.obs(ir, "y_obs", "y", ys)
    s = ys.sum()

    def log_post(mu):
        lik = (n * alpha * math.log(alpha)
               - (n * alpha + s) * np.log(alpha + mu) + s * np.log(mu))
        return lik + (a0 - 1.0) * np.log(mu) - b0 * mu

    mean, sd = quadrature_posterior(log_post, 1e-3, 12.0)
    return GoldStandard("negbin_rate", ir, {"mu": mean}, {"mu": sd})


def _dirichlet_moments(a):
    tot = a.sum()
    return a / tot, np.sqrt(a * (tot - a) / (tot**2 * (tot + 1.0)))


def categorical_dirichlet(seed=36):
    rng = np.random.default_rng(seed)
    K, n = 4, 120
    ys = rng.choice(K, size=n, p=np.array([0.4, 0.3, 0.2, 0.1])).astype(float)
    a0 = np.full(K, 2.0)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "w", dists.Dirichlet, {"alpha": a0})
    ir = Builder.rv(ir, "y", dists.Categorical, {"p": "w"})
    ir = Builder.obs(ir, "y_obs", "y", ys)
    mean, sd = _dirichlet_moments(a0 + np.bincount(ys.astype(int), minlength=K))
    return GoldStandard("categorical_dirichlet", ir, {"w": mean}, {"w": sd})


def multinomial_dirichlet(seed=38):
    rng = np.random.default_rng(seed)
    K, n = 3, 300
    counts = rng.multinomial(n, np.array([0.5, 0.3, 0.2])).astype(float)
    a0 = np.full(K, 3.0)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "w", dists.Dirichlet, {"alpha": a0})
    ir = Builder.rv(ir, "y", dists.Multinomial, {"n": n, "p": "w"}, shape=(K,))
    ir = Builder.obs(ir, "y_obs", "y", counts, reduce="sum")
    mean, sd = _dirichlet_moments(a0 + counts)
    return GoldStandard("multinomial_dirichlet", ir, {"w": mean}, {"w": sd})


def ordered_normal_orderstats(seed=39):
    """The ordered transform on iid N(0, 1), K = 3: the order statistics
    (exact means; sds from a 4e6-sample sorted-iid MC, se ~4e-4)."""
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "x", dists.Normal, {"mu": 0.0, "sigma": 1.0},
                    transform="ordered", shape=(3,))
    m1 = -3.0 / (2.0 * math.sqrt(math.pi))
    sd_outer, sd_mid = 0.74788, 0.66954
    return GoldStandard("ordered_normal_orderstats", ir,
                        {"x": np.array([m1, 0.0, -m1])},
                        {"x": np.array([sd_outer, sd_mid, sd_outer])})


def zero_sum_normal_prior(seed=40):
    """ZeroSumNormal(sigma = 2, K = 4): marginals N(0, sigma^2 (1 - 1/K))."""
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "x", dists.ZeroSumNormal, {"sigma": 2.0}, shape=(4,))
    return GoldStandard("zero_sum_normal_prior", ir, {"x": np.zeros(4)},
                        {"x": np.full(4, 2.0 * math.sqrt(0.75))})


def lkj_marginals(seed=37):
    """LKJ(eta = 2), d = 3: every correlation r_ij of L L' has mean 0 and
    sd 1/sqrt(2 eta + d - 1), checked through ``derived``."""
    eta, d = 2.0, 3
    sd = 1.0 / math.sqrt(2.0 * eta + d - 1.0)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "L", dists.LKJCholesky, {"eta": eta}, shape=(d, d))

    def corr(i, j):
        def fn(trace):
            L = np.asarray(trace["L"])  # (chains, draws, d, d)
            return (L[:, :, i, :] * L[:, :, j, :]).sum(axis=-1)
        return fn

    return GoldStandard("lkj_marginals", ir,
                        {"r12": 0.0, "r13": 0.0, "r23": 0.0},
                        {"r12": sd, "r13": sd, "r23": sd},
                        derived={"r12": corr(1, 0), "r13": corr(2, 0),
                                 "r23": corr(2, 1)})


def kilpisjarvi_real_regression():
    """Linear trend in the real Kilpisjärvi summer temperatures
    1952-2013; target the JAX module's (Laplace-IS)."""
    k = load_kilpisjarvi()
    x = (k["year"] - 1982.5) / 10.0
    y = k["temp_summer"].astype(np.float64)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "alpha", dists.Normal, {"mu": 10.0, "sigma": 10.0})
    ir = Builder.rv(ir, "beta", dists.Normal, {"mu": 0.0, "sigma": 1.0})
    ir = Builder.rv(ir, "sigma", dists.HalfNormal, {"sigma": 5.0})
    ir = Builder.det(ir, "mu_t", lambda a, b, xx: a + b * xx,
                     ["alpha", "beta", x.astype(np.float32)])
    ir = Builder.rv(ir, "temp", dists.Normal,
                    {"mu": "mu_t", "sigma": "sigma"}, shape=(len(y),))
    ir = Builder.obs(ir, "temp_obs", "temp", y.astype(np.float32))
    return _heavy("kilpisjarvi_real_regression", ir)


def diabetes_real_logistic():
    """Logistic regression on the real Pima Indians Diabetes data
    (standardized features); target the JAX module's (Laplace-IS)."""
    dd = load_diabetes()
    Xr = dd["X"].astype(np.float64)
    Xs = (Xr - Xr.mean(axis=0)) / Xr.std(axis=0)
    y = dd["y"].astype(np.float64)
    n, k = Xs.shape
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "alpha", dists.Normal, {"mu": 0.0, "sigma": 2.5})
    ir = Builder.rv(ir, "beta", dists.Normal, {"mu": 0.0, "sigma": 2.5}, shape=(k,))
    ir = Builder.det(ir, "xb", "matmul", [Xs.astype(np.float32), "beta"])
    ir = Builder.det(ir, "eta", "add", ["xb", "alpha"])
    ir = Builder.rv(ir, "y", dists.Bernoulli, {"logits": "eta"}, shape=(n,))
    ir = Builder.obs(ir, "y_obs", "y", y.astype(np.float32))
    return _heavy("diabetes_real_logistic", ir)


def inverse_gamma_variance(seed=40):
    rng = np.random.default_rng(seed)
    n, a0, b0 = 60, 3.0, 4.0
    ys = rng.normal(0.0, 1.4, n)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "v", dists.InverseGamma, {"alpha": a0, "beta": b0})
    ir = Builder.det(ir, "sd", torch.sqrt, ["v"])
    ir = Builder.rv(ir, "y", dists.Normal, {"mu": 0.0, "sigma": "sd"})
    ir = Builder.obs(ir, "y_obs", "y", ys)
    a_n = a0 + n / 2.0
    b_n = b0 + 0.5 * float((ys ** 2).sum())
    mean = b_n / (a_n - 1.0)
    return GoldStandard("inverse_gamma_variance", ir, {"v": mean},
                        {"v": mean / math.sqrt(a_n - 2.0)})


def gumbel_loc(seed=41):
    rng = np.random.default_rng(seed)
    n, loc_true = 40, 0.8
    ys = rng.gumbel(loc_true, 1.0, n)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = Builder.rv(ir, "y", dists.Gumbel, {"loc": "mu", "scale": 1.0})
    ir = Builder.obs(ir, "y_obs", "y", ys)

    def log_post(mu):
        z = ys[:, None] - mu[None, :]
        return (-z - np.exp(-z)).sum(0) - 0.5 * (mu / 5.0) ** 2

    mean, sd = quadrature_posterior(log_post, -2.0, 4.0)
    return GoldStandard("gumbel_loc", ir, {"mu": mean}, {"mu": sd})


def beta_binomial_conc(seed=42):
    rng = np.random.default_rng(seed)
    m, trials, a_true, b_fix = 50, 20, 2.0, 3.0
    p = rng.beta(a_true, b_fix, m)
    ks = rng.binomial(trials, p).astype(np.float64)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "a", dists.Gamma, {"alpha": 2.0, "beta": 0.5})
    ir = Builder.rv(ir, "k", dists.BetaBinomial,
                    {"n": float(trials), "alpha": "a", "beta": b_fix}, shape=(m,))
    ir = Builder.obs(ir, "k_obs", "k", ks)

    def log_post(a):
        aa, kk = a[None, :], ks[:, None]
        ll = (gammaln(kk + aa) + gammaln(trials - kk + b_fix)
              - gammaln(trials + aa + b_fix)
              - gammaln(aa) - gammaln(b_fix) + gammaln(aa + b_fix))
        return ll.sum(0) + (2.0 - 1.0) * np.log(a) - 0.5 * a

    mean, sd = quadrature_posterior(log_post, 1e-3, 15.0)
    return GoldStandard("beta_binomial_conc", ir, {"a": mean}, {"a": sd})


def ordered_logistic_eta(seed=43):
    """Ordinal outcomes with fixed cutpoints, Normal prior on eta."""
    rng = np.random.default_rng(seed)
    n, eta_true = 80, 0.6
    c = np.array([-1.0, 0.9])

    def sig(t):
        return 1.0 / (1.0 + np.exp(-t))

    full = np.concatenate([[1.0], sig(eta_true - c), [0.0]])
    probs = full[:-1] - full[1:]
    ys = rng.choice(3, size=n, p=probs / probs.sum()).astype(np.float64)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "eta", dists.Normal, {"mu": 0.0, "sigma": 2.0})
    ir = Builder.rv(ir, "y", dists.OrderedLogistic,
                    {"eta": "eta", "cutpoints": c}, shape=(n,))
    ir = Builder.obs(ir, "y_obs", "y", ys)
    counts = np.bincount(ys.astype(int), minlength=3).astype(np.float64)

    def log_post(eta):
        sg = [np.ones_like(eta), sig(eta - c[0]), sig(eta - c[1]), np.zeros_like(eta)]
        ll = sum(counts[k] * np.log(np.clip(sg[k] - sg[k + 1], 1e-300, None))
                 for k in range(3))
        return ll - 0.5 * (eta / 2.0) ** 2

    mean, sd = quadrature_posterior(log_post, -2.5, 3.5)
    return GoldStandard("ordered_logistic_eta", ir, {"eta": mean}, {"eta": sd})


def crossed_random_effects_lmm(seed=50, n_rows=30, n_cols=20):
    """Crossed random effects, balanced 30 x 20 design (d = 54):
    y_ij ~ N(mu + a_i + b_j, sigma_y), a, b auto-NCP'd; target the JAX
    module's (closed-form two-way ANOVA marginal + Laplace-IS)."""
    I, J = n_rows, n_cols
    rng = np.random.default_rng(seed)
    a_true = rng.normal(0.0, 0.6, I)
    b_true = rng.normal(0.0, 0.4, J)
    y = 2.0 + a_true[:, None] + b_true[None, :] + rng.normal(0.0, 0.8, (I, J))
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": 10.0})
    ir = Builder.rv(ir, "sigma_a", dists.HalfNormal, {"sigma": 1.0})
    ir = Builder.rv(ir, "sigma_b", dists.HalfNormal, {"sigma": 1.0})
    ir = Builder.rv(ir, "sigma_y", dists.HalfNormal, {"sigma": 1.0})
    ir = Builder.rv(ir, "a", dists.Normal, {"mu": 0.0, "sigma": "sigma_a"}, shape=(I,))
    ir = Builder.rv(ir, "b", dists.Normal, {"mu": 0.0, "sigma": "sigma_b"}, shape=(J,))
    ir = Builder.det(ir, "a_row", "getitem", ["a", np.repeat(np.arange(I), J)])
    ir = Builder.det(ir, "b_col", "getitem", ["b", np.tile(np.arange(J), I)])
    ir = Builder.det(ir, "mu_y", lambda m, ar, bc: m + ar + bc,
                     ["mu", "a_row", "b_col"])
    ir = Builder.rv(ir, "y", dists.Normal,
                    {"mu": "mu_y", "sigma": "sigma_y"}, shape=(I * J,))
    ir = Builder.obs(ir, "y_obs", "y", y.reshape(-1).astype(np.float32))
    return _heavy("crossed_random_effects_lmm", ir, ncp=True)


def avtest_binomial_glmm():
    """Logistic-binomial GLMM on the real AV-TEST detection counts
    (10 engines); target the JAX module's (2-d grid quadrature)."""
    raw = load_csv("avtest_detection")
    engines = sorted(set(raw["engine"]))
    N_e = np.array([raw["n_tested"][raw["engine"] == e].sum()
                    for e in engines], np.float64)
    k_e = np.array([raw["n_detected"][raw["engine"] == e].sum()
                    for e in engines], np.float64)
    E = len(engines)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": 10.0})
    ir = Builder.rv(ir, "sigma_a", dists.HalfNormal, {"sigma": 1.0})
    ir = Builder.rv(ir, "a", dists.Normal, {"mu": 0.0, "sigma": "sigma_a"}, shape=(E,))
    ir = Builder.det(ir, "logits", lambda m, a: m + a, ["mu", "a"])
    ir = Builder.rv(ir, "k", dists.Binomial,
                    {"n": N_e.astype(np.float32), "logits": "logits"}, shape=(E,))
    ir = Builder.obs(ir, "k_obs", "k", k_e.astype(np.float32))
    return _heavy("avtest_binomial_glmm", ir, ncp=True)


def kilpisjarvi_ordinal():
    """Ordinal regression with free ordered cutpoints on the real
    Kilpisjärvi terciles; target the JAX module's (3-d grid quadrature)."""
    data = load_kilpisjarvi()
    temp = data["temp_summer"]
    year = data["year"].astype(np.float64)
    x = (year - year.mean()) / year.std()
    q1, q2 = np.quantile(temp, [1 / 3, 2 / 3])
    y = (temp > q1).astype(int) + (temp > q2).astype(int)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "beta", dists.Normal, {"mu": 0.0, "sigma": 2.0})
    ir = Builder.rv(ir, "c", dists.Normal, {"mu": 0.0, "sigma": 5.0},
                    transform="ordered", shape=(2,))
    ir = Builder.det(ir, "eta", lambda b, xx: b * xx, ["beta", x.astype(np.float32)])
    ir = Builder.rv(ir, "y", dists.OrderedLogistic,
                    {"eta": "eta", "cutpoints": "c"}, shape=(len(y),))
    ir = Builder.obs(ir, "y_obs", "y", y.astype(np.float64))
    return _heavy("kilpisjarvi_ordinal", ir)


EXTRA_GOLD_STANDARDS = [
    exponential_gamma,
    lognormal_conjugate,
    uniform01_bernoulli,
    custom_gaussian_conjugate,
    dirichlet_prior_moments,
    mvn_dense_mass,
    linreg_meas_obs_matmul,
    affine_meas_obs,
    studentt_loc,
    cauchy_loc,
    laplace_loc,
    weibull_rate,
    halfnormal_scale,
    truncnorm_loc,
    uniform_interval_normal,
    mixture_loc,
    censored_right_normal,
    censored_interval_normal,
    poisson_log_link,
    grw_kalman_t1000,
    stan_eight_schools,
    stan_uniform_normal,
    stan_logistic_1d,
    stan_eight_schools_ncp,
    stan_logistic_d21,
    funnel_v_marginal,
    radon_varying_intercept,
    kidiq_regression,
    flat_prior_normal,
    binomial_beta,
    inverse_gamma_variance,
    gumbel_loc,
    beta_binomial_conc,
    ordered_logistic_eta,
    negbin_rate,
    categorical_dirichlet,
    lkj_marginals,
    multinomial_dirichlet,
    ordered_normal_orderstats,
    zero_sum_normal_prior,
    kilpisjarvi_real_regression,
    diabetes_real_logistic,
    crossed_random_effects_lmm,
    avtest_binomial_glmm,
    kilpisjarvi_ordinal,
]

# Targets of the JAX module's slow mechanisms (Laplace-IS with 400k
# draws, dense grids), stored as float64 constants; equal to
# exmc_tpu.benchmarks.gold_models (tests/test_torch_golds.py).
HEAVY_TARGETS = {
    'radon_varying_intercept': {
        'means': {
            'mu_a': 1.5397104364295413,
            'beta': -0.7962361638521915,
            'sigma_a': 0.3202786782667406,
            'sigma_y': 0.7377198534985836,
            'alpha': [
                1.5377016258800529, 1.6410994263348135, 1.6899821821092804,
                1.534196806439189, 1.6331178704789053, 1.5313756004955568,
                1.4808730286420904, 1.5229294621770428, 1.3957027017112913,
                1.3548740784375508, 1.6652758115329096, 1.5833682611425046,
                1.3501084100061946, 1.554301283829937, 1.4895326640946314,
                1.5439962853965725, 1.5405650114415153, 1.6421548064176603,
                1.326696277282194, 1.5359119013939144, 1.500187647796903,
                1.3011245781086056, 1.7323941402008234, 1.399313602132616,
                1.4199709050910732, 1.6957749719513773, 1.597542113321427,
                1.4416523636431038, 1.5770709050237148, 1.412471862876472,
                1.531213705346142, 1.5353954725136127, 1.4423596192427557,
                1.8894075298182134, 1.6071531575154747, 1.6771066903172311,
                1.8272420721149618, 1.8975020757467984, 1.4362276649664758,
                1.5833913830267414, 1.6384443199318994, 1.5719562987267999,
                1.4666679616261198, 1.3872190534520592, 1.6285792656443632,
                1.620178623016312, 1.4571957132867994, 1.5071661826228326,
                1.6795258292309907, 1.6919336297303955, 1.4734678184210197,
                1.396089923329183, 1.4651435730418627, 1.6734446119864494,
                1.7178821162458657, 1.5972261370763787, 1.410591602096634,
                1.4915011938326566, 1.6254170190849824, 1.6412138197239143,
                1.3631389541476684, 1.2326312889573596, 1.5979621775180337,
                1.5607258212995914, 1.711640576043651, 1.6845479737085156,
                1.3848455270801607, 1.301791641171154, 1.4644802414901905,
                1.320881030820885, 1.4124584939861244, 1.310282589845287,
                1.5124054487024792, 1.5719952685978875, 1.5478098610626585,
                1.478997973089161, 1.550626512243454, 1.7248444398157028,
                1.268192590938273, 1.603835347846911, 1.6848262378704633,
                1.6715633485567325, 1.5361964108279362, 1.5321593272418799,
                1.6479053566361563
            ],
        },
        'sds': {
            'mu_a': 0.09400352333164515,
            'beta': 0.049180470565917005,
            'sigma_a': 0.12117791629051075,
            'sigma_y': 0.017701517421354368,
            'alpha': [
                0.3107574244358702, 0.320030382321719, 0.3274868140367567,
                0.31064020156615474, 0.31892472228802904, 0.31055543009059094,
                0.3098475386833717, 0.31035283213442916, 0.3165476771725566,
                0.3215064202208981, 0.32375858817785597, 0.3128222092246633,
                0.3222629484435564, 0.3108342852032342, 0.30966105045226666,
                0.3110010464405698, 0.31020782098155153, 0.3195216057850848,
                0.3268669225373216, 0.3106959168293185, 0.31018963166703356,
                0.33183133920780317, 0.33630173788088674, 0.3161372861431176,
                0.31342658870023254, 0.32925028590492217, 0.3147742458714147,
                0.3117008268780606, 0.3123157613493224, 0.3141378950781276,
                0.3098972487434664, 0.310024499336766, 0.31228163768868433,
                0.381709031764638, 0.31576865050432923, 0.32578639540618753,
                0.361306678612133, 0.3844574456369526, 0.31271264666507004,
                0.3128241454245437, 0.31899569990723686, 0.31259414859696666,
                0.31096568926707435, 0.3175638715895547, 0.3183241713563142,
                0.31726694490235685, 0.3107695237792161, 0.30953177836513524,
                0.32621717084859914, 0.32851149260045287, 0.31007114877710706,
                0.3165030334513006, 0.31102968628293387, 0.32514466869494063,
                0.33310840263952757, 0.3140826997396217, 0.31432538225519613,
                0.3096299521139463, 0.31791789183170865, 0.32004668547201853,
                0.32024646465130785, 0.3473708285811665, 0.314155230609145,
                0.31119652762688776, 0.33179086723614193, 0.3264734887810119,
                0.3172569340685739, 0.3316943980559646, 0.31105831110535676,
                0.3279438448753144, 0.314139215232031, 0.32998577341143637,
                0.31020794847458594, 0.31259694759738743, 0.31051304105272265,
                0.30989857308733115, 0.31064689381118876, 0.334617955503796,
                0.03322108293336435, 0.3147540285769707, 0.32717996366498897,
                0.3248198852275342, 0.31005102029347187, 0.3099243757449375,
                0.3203633813322683
            ],
        },
    },
    'kidiq_regression': {
        'means': {
            'b0': 83.66155305858169,
            'b_hs': 3.2551923311150706,
            'b_iq': 0.6543442354699275,
            'sigma': 18.381460729935192,
        },
        'sds': {
            'b0': 1.808675342438078,
            'b_hs': 2.0535970765340466,
            'b_iq': 0.05547077132184614,
            'sigma': 0.6270652682041148,
        },
    },
    'crossed_random_effects_lmm': {
        'means': {
            'mu': 1.8736070055092704,
            'sigma_a': 0.6507597958469548,
            'sigma_b': 0.5385603721920844,
            'sigma_y': 0.7674102184595302,
            'a': [
                0.44766304155876124, 0.08211578520190839, 0.514675875547495,
                -0.6487059993608848, 1.1172996143646934, 0.2480162802718332,
                0.4335982084618804, 0.5619021137156404, 0.67207922963984,
                0.4392556525248263, -0.5566177168638105, 0.008656228751107838,
                -0.2935727584230772, 0.21236838356895132, -1.4823888254070838,
                -0.6671047691427482, 0.2206813397126205, 0.3795944271137529,
                -0.33644253677676617, -0.47382613151748953, -0.24169108811419898,
                0.032254264477515324, -1.6042026765262267, 0.1393269526153894,
                -0.17281324488180427, -0.17257546295645276, 0.5733097924353168,
                -0.40439912849345977, 0.4407866107462687, 0.5370420806167651
            ],
            'b': [
                -0.1007425783926109, 0.12575160227240084, 0.34219353618206866,
                0.8916285996969548, -0.16051197775960216, -0.3996448030548702,
                -0.02506715678669546, 1.000229121021311, 0.09680136728346647,
                0.019027939804800022, -0.3571823146564432, -0.5358163148211955,
                -0.37603471243060976, 1.0094408435397508, -0.5844447879585468,
                -0.46164235166198647, 0.04108156641513702, 0.18648292674275857,
                -0.37069111384257764, -0.33795257836621084
            ],
        },
        'sds': {
            'mu': 0.17406081118061634,
            'sigma_a': 0.09514038438355521,
            'sigma_b': 0.1000024635149383,
            'sigma_y': 0.023182228306815125,
            'a': [
                0.2025074375102661, 0.20231765954106684, 0.20257061646386165,
                0.20272382367827885, 0.20353184073418706, 0.20237132405457275,
                0.2024952927340944, 0.20262041466184047, 0.20275352436472954,
                0.20250013131454606, 0.2026150697028318, 0.20231114623928545,
                0.20239574065249347, 0.20235523917435658, 0.20445646456680014,
                0.20274753550848215, 0.2023587673122602, 0.20245225887963322,
                0.20242224588880356, 0.202531436515876, 0.20236848111348635,
                0.20231208407690354, 0.20482123846599326, 0.202330066782085,
                0.20234044610535093, 0.20234036543862463, 0.20263309703461696,
                0.20247163861399103, 0.20250145144873719, 0.20259365745559887
            ],
            'b': [
                0.17987101529978666, 0.17987505069033285, 0.18004116587516386,
                0.1811709861181202, 0.17989892073608807, 0.18013142516562722,
                0.17985303629002347, 0.1815134267774952, 0.17986485077688144,
                0.17985150347695966, 0.18007603707214398, 0.18035001784588958,
                0.18009987750026438, 0.1815442643512922, 0.18044318527707384,
                0.18022320957530572, 0.17985320737545238, 0.17990566715860346,
                0.1800929983118136, 0.18005295500726168
            ],
        },
    },
    'avtest_binomial_glmm': {
        'means': {
            'mu': 4.604253764740792,
            'sigma_a': 1.091520212074924,
            'a': [
                0.39317058566218865, 1.457373358361626, -2.2897967973925066,
                -0.21400816465569292, 1.0855830678955427, -0.03929120749556129,
                0.6210294564793974, -0.4780332891142843, -0.3488000433076923,
                -0.12936555378464945
            ],
        },
        'sds': {
            'mu': 0.35474110759368055,
            'sigma_a': 0.2561981998437628,
            'a': [
                0.3584967859477247, 0.3654361294130349, 0.3550480288513279,
                0.3568159200138964, 0.3621580552363428, 0.3572008964308499,
                0.3594382545851865, 0.3563473446919172, 0.3565613659581553,
                0.35699409701516865
            ],
        },
    },
    'kilpisjarvi_real_regression': {
        'means': {
            'alpha': 9.312871693733427,
            'beta': 0.20381943898971489,
            'sigma': 1.1312528928666434,
        },
        'sds': {
            'alpha': 0.14413606184268907,
            'beta': 0.08028750431318007,
            'sigma': 0.10610029490463915,
        },
    },
    'kilpisjarvi_ordinal': {
        'means': {
            'beta': 0.5713769208818845,
            'c': [
                -0.5618656356336686, 0.8502840438315126
            ],
        },
        'sds': {
            'beta': 0.25678457875986205,
            'c': [
                0.27418231986734604, 0.2860767097340375
            ],
        },
    },
    'stan_logistic_d21': {
        'means': {
            'beta': [
                0.7267707561891643, -0.3529081219242249, 0.30487225901929277,
                1.1547348468620064, -0.18840387358300634, 0.22751487866709397,
                -0.22568214939188877, 0.3496640050261371, -0.422698056851553,
                0.7983074016775188, 0.22413969899822223, 0.20174570221621851,
                0.025303519510855767, -0.8593426634839199, 0.5799866663096497,
                0.25746655192503837, -0.6262854750552398, 0.46233752464608646,
                -1.0348696422143682, 0.11761278929709812, 0.7605358555561578
            ],
        },
        'sds': {
            'beta': [
                0.14135087015297584, 0.1229052758132, 0.132761632829056,
                0.14988726081557388, 0.11950233234082185, 0.12216945639442431,
                0.12786216402671413, 0.1292603720682045, 0.1273243345665528,
                0.14071669691140676, 0.12501917090036252, 0.13087024453364976,
                0.1267580648381488, 0.14761228504699658, 0.14018911647717774,
                0.13689907163279003, 0.13106528319105804, 0.13668476369003935,
                0.15602159212221245, 0.13654138308893898, 0.13422175131196384
            ],
        },
    },
    'diabetes_real_logistic': {
        'means': {
            'alpha': -0.8784643790106833,
            'beta': [
                0.41950465921065144, 1.1398474698221266, -0.26049855939383143,
                0.010342688638976683, -0.13854668949069437, 0.7185871536592567,
                0.317796189985749, 0.176338635669356
            ],
        },
        'sds': {
            'alpha': 0.0976081729893041,
            'beta': [
                0.10861633731443532, 0.11945918263284504, 0.10231592323341672,
                0.1107966581087924, 0.10498987082003185, 0.11974639693292578,
                0.09981360420501016, 0.11069654146784828
            ],
        },
    },
}
