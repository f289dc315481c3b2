"""``exmc_tpu_torch.kalman`` and the port's AR(1)/AR(p) Laplace marginals
against the JAX package and the exact oracles: the counterparts of
``tests/test_kalman.py``'s nine tests, run on the port on the CPU, plus
the filter, smoother and ``interop.ssm_from_numpy`` held to JAX on the
same numpy inputs. Tolerances: the JAX tests' own where the port runs
the same check; f32 parity with JAX's filter 1e-4 relative (both
sequential, the same recurrences); 1e-6 against a dense f64 oracle
under ``config.x64``."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from exmc_tpu import kalman as jk
import exmc_tpu_torch
from exmc_tpu_torch import config, dists, interop
from exmc_tpu_torch.benchmarks.gold_models import kalman_smoother_grw
from exmc_tpu_torch.kalman import (
    add_obs_noise,
    ar_ssm,
    grw_ssm,
    kalman_filter,
    kalman_loglik,
    kalman_smoother,
    seasonal_ssm,
    stationary_cov,
)
from exmc_tpu_torch.marginal import make_ar1_marginal, make_arp_marginal, make_grw_marginal
from test_torch_families import one_torch_thread  # noqa: F401 (autouse)

CPU = "cpu"


def _dense_lgssm_loglik(F, Q, h, r, mu0, P0, ys):
    """Independent oracle: the joint Gaussian of the T scalar
    observations, evaluated densely in f64."""
    T = len(ys)
    Ps, means = [P0], [mu0]
    for _ in range(T - 1):
        means.append(F @ means[-1])
        Ps.append(F @ Ps[-1] @ F.T + Q)
    cov = np.zeros((T, T))
    mu_y = np.array([h @ m for m in means])
    for s in range(T):
        acc = Ps[s]
        cov[s, s] = h @ acc @ h + r
        for t in range(s + 1, T):
            acc = acc @ F.T
            cov[s, t] = cov[t, s] = h @ acc @ h
    resid = ys - mu_y
    sign, logdet = np.linalg.slogdet(cov)
    assert sign > 0
    return float(-0.5 * (T * np.log(2 * np.pi) + logdet + resid @ np.linalg.solve(cov, resid)))


def _gauss_loglik(ys, r_sd, const=True):
    y_t = torch.as_tensor(ys, dtype=config.default_dtype())
    c = np.log(r_sd * np.sqrt(2 * np.pi)) if const else 0.0

    def loglik(s, theta):
        return -0.5 * ((y_t - s) / r_sd) ** 2 - c

    return loglik


def test_kalman_matches_gold_grw_smoother():
    rng = np.random.default_rng(0)
    T, q, r = 200, 0.3, 0.5
    ys = np.cumsum(rng.normal(0, q, T)) + rng.normal(0, r, T)
    gold_m, gold_sd = kalman_smoother_grw(ys, q, r)
    mu_s, P_s = kalman_smoother(add_obs_noise(grw_ssm(q, device=CPU), r ** 2), ys)
    assert np.allclose(mu_s[:, 0].numpy(), gold_m, atol=2e-4)
    assert np.allclose(np.sqrt(P_s[:, 0, 0].numpy()), gold_sd, atol=2e-4)


def test_kalman_loglik_matches_dense_ar2():
    rng = np.random.default_rng(1)
    T, phis, sigma, r = 40, np.array([0.5, 0.3]), 0.7, 0.4
    ssm = add_obs_noise(ar_ssm(phis, sigma, device=CPU), r ** 2)
    x = rng.normal(size=T)
    ll = float(kalman_loglik(ssm, x))
    F, Q, h, P0 = (a.double().numpy() for a in (ssm.F, ssm.Q, ssm.h, ssm.P0))
    dense = _dense_lgssm_loglik(F, Q, h, r ** 2, np.zeros(2), P0, x)
    assert abs(ll - dense) < 1e-3 * max(1.0, abs(dense))
    with config.x64():
        ll64 = float(kalman_loglik(add_obs_noise(ar_ssm(phis, sigma, device=CPU), r ** 2), x))
    assert abs(ll64 - dense) < 1e-6 * max(1.0, abs(dense))


def test_stationary_cov_fixed_point():
    ssm = ar_ssm(np.array([0.6, 0.25]), 0.9, device=CPU)
    F, Q, P = (a.double().numpy() for a in (ssm.F, ssm.Q, ssm.P0))
    assert np.allclose(F @ P @ F.T + Q, P, atol=1e-5)
    # batched transitions solve each point's equation
    Fb = torch.stack([ssm.F, 0.5 * ssm.F])
    Pb = stationary_cov(Fb, ssm.Q)
    np.testing.assert_allclose(Pb[0].numpy(), ssm.P0.numpy(), rtol=1e-6)
    np.testing.assert_allclose(Pb[1].numpy(), stationary_cov(0.5 * ssm.F, ssm.Q).numpy(),
                               rtol=1e-6)


def _ar1_series(seed, T, phi0, sig0, r_sd):
    rng = np.random.default_rng(seed)
    s = np.zeros(T)
    s[0] = rng.normal(0, sig0 / np.sqrt(1 - phi0 ** 2))
    for t in range(1, T):
        s[t] = phi0 * s[t - 1] + rng.normal(0, sig0)
    return s + rng.normal(0, r_sd, T)


def test_ar1_marginal_matches_exact_kalman():
    """Gaussian observations: the Laplace marginal is EXACT, so logZ,
    the mode and the variances equal the Kalman quantities, across
    hyperparameter values (T = 256 here; the JAX test's 300)."""
    T, r_sd = 256, 0.6
    ys = _ar1_series(2, T, 0.95, 0.25, r_sd)
    marginal = make_ar1_marginal(_gauss_loglik(ys, r_sd), T, newton_iters=8)
    for sigma, phi in [(0.25, 0.95), (0.4, 0.8), (0.15, 0.99), (0.3, -0.5)]:
        logZ, s_hat, var_hat = marginal(torch.tensor(sigma), torch.tensor(phi), {})
        ssm = add_obs_noise(ar_ssm(np.array([phi]), sigma, device=CPU), r_sd ** 2)
        ll = float(kalman_loglik(ssm, ys))
        assert abs(float(logZ) - ll) < 5e-2 + 2e-4 * abs(ll), (sigma, phi)
        mu_s, P_s = kalman_smoother(ssm, ys)
        assert np.allclose(s_hat.numpy(), mu_s[:, 0].numpy(), atol=5e-3)
        assert np.allclose(var_hat.numpy(), P_s[:, 0, 0].numpy(), atol=5e-3)


def test_ar1_marginal_is_differentiable_in_both_hypers():
    T = 80
    ys = np.random.default_rng(3).normal(size=T)
    marginal = make_ar1_marginal(_gauss_loglik(ys, 0.5, const=False), T, newton_iters=6)

    def f(sigma, phi):
        return marginal(sigma, phi, {})[0]

    x = torch.tensor([0.3, 0.7], requires_grad=True)
    g = torch.autograd.grad(f(x[0], x[1]), x)[0]
    assert torch.isfinite(g).all()
    eps = 1e-3
    fd = (float(f(torch.tensor(0.3), torch.tensor(0.7 + eps)))
          - float(f(torch.tensor(0.3), torch.tensor(0.7 - eps)))) / (2 * eps)
    assert abs(float(g[1]) - fd) < 3e-2 * max(1.0, abs(fd))


def test_grw_marginal_unchanged_by_refactor():
    rng = np.random.default_rng(4)
    T, q, r = 150, 0.3, 0.5
    ys = np.cumsum(rng.normal(0, q, T)) + rng.normal(0, r, T)
    logZ, _, _ = make_grw_marginal(_gauss_loglik(ys, r), T, newton_iters=8)(
        torch.tensor(q), {})
    ll = float(kalman_loglik(add_obs_noise(grw_ssm(q, device=CPU), r ** 2), ys))
    assert abs(float(logZ) - ll) < 5e-2 + 2e-4 * abs(ll)


def test_seasonal_ssm_tracks_periodic_signal():
    rng = np.random.default_rng(5)
    period, cycles = 4, 30
    T = period * cycles
    pattern = np.array([2.0, -1.0, 0.5, -1.5])
    ys = np.tile(pattern, cycles) + rng.normal(0, 0.3, T)
    mu_s, _ = kalman_smoother(add_obs_noise(seasonal_ssm(period, 0.05, device=CPU),
                                            0.3 ** 2), ys)
    want = pattern[np.arange(T - period, T) % period]
    assert np.allclose(mu_s[-period:, 0].numpy(), want, atol=0.25)


def _ar2_series():
    rng = np.random.default_rng(6)
    T, r_sd = 200, 0.5
    s = np.zeros(T)
    for t in range(2, T):
        s[t] = np.array([0.5, 0.3]) @ s[[t - 1, t - 2]] + rng.normal(0, 0.4)
    return s + rng.normal(0, r_sd, T), T, r_sd


@pytest.mark.parametrize("x64", [False, True])
def test_arp_banded_marginal_matches_exact_kalman(x64):
    """AR(2) banded Laplace marginal vs the exact Kalman likelihood: logZ,
    means and variances (f32: the JAX test's tolerances; f64: 1e-5)."""
    ys, T, r_sd = _ar2_series()
    with config.x64(x64):
        marginal = make_arp_marginal(_gauss_loglik(ys, r_sd), T, p=2, newton_iters=8)
        for sigma, phis in [(0.4, (0.5, 0.3)), (0.25, (1.2, -0.4)), (0.6, (0.1, 0.6))]:
            logZ, s_hat, var_hat = marginal(torch.tensor(sigma), torch.tensor(phis), {})
            ssm = add_obs_noise(ar_ssm(np.asarray(phis), sigma, device=CPU), r_sd ** 2)
            ll = float(kalman_loglik(ssm, ys))
            mu_s, P_s = kalman_smoother(ssm, ys)
            tol = (1e-5, 1e-6) if x64 else (5e-2 + 2e-4 * abs(ll), 5e-3)
            assert abs(float(logZ) - ll) < tol[0], (sigma, phis)
            assert np.allclose(s_hat.numpy(), mu_s[:, 0].numpy(), atol=tol[1])
            assert np.allclose(var_hat.numpy(), P_s[:, 0, 0].numpy(), atol=tol[1])


def test_arp_banded_marginal_gradients():
    T = 60
    ys = np.random.default_rng(7).normal(size=T)
    marginal = make_arp_marginal(_gauss_loglik(ys, 0.5, const=False), T, p=2,
                                 newton_iters=6)

    def f(sigma, phis):
        return marginal(sigma, phis, {})[0]

    x = torch.tensor([0.4, 0.5, 0.2], requires_grad=True)
    g = torch.autograd.grad(f(x[0], x[1:]), x)[0]
    assert torch.isfinite(g).all()
    eps = 1e-3
    ph = torch.tensor([0.5, 0.2])
    fd = (float(f(torch.tensor(0.4 + eps), ph)) - float(f(torch.tensor(0.4 - eps), ph))) / (2 * eps)
    assert abs(float(g[0]) - fd) < 3e-2 * max(1.0, abs(fd))


# ---------------------------------------------------------------------------
# parity with the JAX package on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["grw", "ar2", "seasonal"])
def test_filter_and_smoother_match_jax(kind):
    rng = np.random.default_rng(8)
    T = 60
    ys = rng.normal(size=T)
    make = {"grw": lambda m: m.grw_ssm(0.3), "ar2": lambda m: m.ar_ssm(np.array([0.5, 0.3]), 0.7),
            "seasonal": lambda m: m.seasonal_ssm(4, 0.2)}[kind]
    jssm = jk.add_obs_noise(make(jk), 0.25)
    tssm = interop.ssm_from_numpy(jssm, device=CPU)
    jll, (jm, jP, jmp, jPp) = jk.kalman_filter(jssm, jnp.asarray(ys, jnp.float32))
    tll, (tm, tP, tmp, tPp) = kalman_filter(tssm, ys)
    assert abs(float(tll) - float(jll)) < 1e-4 * abs(float(jll))
    # the seasonal model's diffuse prior (P0 = 1e4 sigma^2) makes the
    # first covariance updates cancel in f32: absolute 5e-4 there
    atol = 5e-4 if kind == "seasonal" else 1e-5
    for a, b in ((tm, jm), (tP, jP), (tmp, jmp), (tPp, jPp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=atol)
    jms, jPs = jk.kalman_smoother(jssm, jnp.asarray(ys, jnp.float32))
    tms, tPs = kalman_smoother(tssm, ys)
    np.testing.assert_allclose(tms.numpy(), np.asarray(jms), rtol=1e-4, atol=max(atol, 1e-4))
    np.testing.assert_allclose(tPs.numpy(), np.asarray(jPs), rtol=1e-4, atol=max(atol, 1e-4))
    # the port's own constructors build the same model
    own = {"grw": lambda: grw_ssm(0.3, device=CPU),
           "ar2": lambda: ar_ssm(np.array([0.5, 0.3]), 0.7, device=CPU),
           "seasonal": lambda: seasonal_ssm(4, 0.2, device=CPU)}[kind]()
    own = add_obs_noise(own, 0.25)
    for f in own._fields:
        np.testing.assert_allclose(getattr(own, f).numpy(), np.asarray(getattr(jssm, f)),
                                   rtol=1e-5, atol=1e-6)


def test_ar1_marginal_nuts():
    """Example 47 at a small size: NUTS on (sigma, phi) under the AR(1)
    Laplace marginal (a ``Custom`` likelihood), then the exact Kalman
    smoother's bands at the posterior mean hold the latent path."""
    T, r_sd = 60, 0.5
    rng = np.random.default_rng(0)
    s = np.zeros(T)
    s[0] = rng.normal(0, 0.35 / np.sqrt(1 - 0.81))
    for t in range(1, T):
        s[t] = 0.9 * s[t - 1] + rng.normal(0, 0.35)
    ys = s + rng.normal(0, r_sd, T)
    marginal = make_ar1_marginal(_gauss_loglik(ys, r_sd, const=False), T, newton_iters=6)

    def lp(_value, params):
        return marginal(params["sigma"], params["phi"], {})[0]

    B = exmc_tpu_torch.Builder
    ir = B.rv(B.new_ir(), "sigma", dists.HalfNormal, {"sigma": 1.0})
    ir = B.rv(ir, "phi", dists.Uniform, {"lower": -0.99, "upper": 0.99})
    ir = B.rv(ir, "lik", dists.Custom(logpdf_fn=lp, support="real"),
              {"sigma": "sigma", "phi": "phi"})
    ir = B.obs(ir, "lik_obs", "lik", 0.0)
    trace, stats = exmc_tpu_torch.sample(ir, ncp=False, num_chains=2, num_warmup=60,
                                         num_samples=60, seed=0, device="cpu")
    assert stats["divergences"].sum() == 0
    phi, sig = float(trace["phi"].mean()), float(trace["sigma"].mean())
    assert 0.5 < phi < 1.0
    mu_s, P_s = kalman_smoother(add_obs_noise(ar_ssm(np.array([phi]), sig, device=CPU),
                                              r_sd ** 2), ys)
    inside = np.abs(mu_s[:, 0].numpy() - s) < 2.5 * np.sqrt(P_s[:, 0, 0].numpy())
    assert inside.mean() > 0.9
