"""MAP, Laplace, PSIR and Pareto smoothing in the port against the JAX
package on the CPU:

* ``fit_map``: the MAP point, ``converged`` and ``iters`` equal JAX's
  (optax's L-BFGS with its zoom line search), with the random start's
  normals injected: the conjugate Normal, LogNormal with
  ``jacobian=False`` (the mode exp(-1)), a HalfNormal scale and a small
  logistic regression, with both ``jacobian`` settings and ``seed=None``;
  an ``init``; a fully observed model;
* ``laplace``: ``cov_logdet``, the jitter used and the draws under JAX's
  eps; the jitter ladder and its ``ValueError``; the Hessian by double
  backward equal to ``jax.hessian`` on golds covering the density's ops;
* ``psir``: ``pareto_k``, ``ess_is``, the smoothed weights and the
  resampled indices on the same draws and log-q; ``_psis_smooth`` on
  seeded weights.

Tolerances: 1e-4 relative / 1e-5 absolute in f32; the iteration counts
and indices exactly; log-densities of N terms 2e-5 of max(1, |value|).
"""

import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu import model_comparison as jmc
from exmc_tpu import optimize as jopt
from exmc_tpu.compiler import compile_logp as jcompile
from exmc_tpu.psir import diag_normal_logq as j_logq, psir as j_psir
from exmc_tpu_torch import model_comparison as tmc
from exmc_tpu_torch import optimize as topt
from exmc_tpu_torch.compiler import compile_logp as tcompile
from exmc_tpu_torch.psir import diag_normal_logq as t_logq, psir as t_psir

from test_torch_golds import _compiled
from test_torch_vi import logistic, quickstart

RTOL, ATOL = 1e-4, 1e-5


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def conjugate(pkg):
    B, D = pkg.Builder, pkg.dists
    ir = B.new_ir()
    ir = B.rv(ir, "mu", D.Normal, {"mu": 0.0, "sigma": 10.0})
    ir = B.rv(ir, "y", D.Normal, {"mu": "mu", "sigma": 2.0}, shape=(6,))
    return B.obs(ir, "y_obs", "y", np.array([1.2, 3.1, 2.2, 0.4, 2.9, 1.7], np.float32))


def halfnormal_scale(pkg):
    B, D = pkg.Builder, pkg.dists
    ir = B.new_ir()
    ir = B.rv(ir, "sigma", D.HalfNormal, {"sigma": 2.0})
    ir = B.rv(ir, "y", D.Normal, {"mu": 0.0, "sigma": "sigma"}, shape=(5,))
    return B.obs(ir, "y_obs", "y", np.array([0.5, -1.3, 2.2, 0.1, -0.8], np.float32))


def lognormal(pkg):
    return pkg.Builder.rv(pkg.Builder.new_ir(), "x", pkg.dists.LogNormal,
                          {"mu": 0.0, "sigma": 1.0})


MODELS = {"conjugate": conjugate, "halfnormal_scale": halfnormal_scale,
          "lognormal": lognormal, "logistic": logistic, "quickstart": quickstart}


def start_noise(seed, d):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (d,), jnp.float32))


@pytest.mark.parametrize("model", ["conjugate", "halfnormal_scale", "lognormal",
                                   "logistic"])
@pytest.mark.parametrize("jacobian", [True, False])
@pytest.mark.parametrize("seed", [3, None])
def test_fit_map_matches_jax(model, jacobian, seed):
    jp, ji = jopt.fit_map(MODELS[model](exmc_tpu), seed=seed, jacobian=jacobian)
    noise = None if seed is None else start_noise(seed, ji["z_map"].shape[0])
    tp, ti = topt.fit_map(MODELS[model](exmc_tpu_torch), seed=seed, jacobian=jacobian,
                          device="cpu", noise=noise)
    assert ti["iters"] == ji["iters"]
    assert ti["converged"] == ji["converged"]
    _close(ti["z_map"], ji["z_map"])
    assert sorted(tp) == sorted(jp)
    for k in jp:
        _close(tp[k], jp[k])
    assert ti["logp"] == pytest.approx(ji["logp"], rel=2e-5, abs=2e-5)
    # one sync per iteration's stopping test and one per line-search step
    assert ti["host_syncs"] > ti["iters"]


def test_lognormal_penalized_mode():
    """Stan's jacobian=false objective puts the LogNormal(0, 1) mode at
    exp(-1); the sampler's density (jacobian=True) at exp(0)."""
    tp, ti = topt.fit_map(lognormal(exmc_tpu_torch), jacobian=False, device="cpu")
    assert ti["converged"] and tp["x"] == pytest.approx(np.exp(-1.0), rel=1e-5)
    tp, _ = topt.fit_map(lognormal(exmc_tpu_torch), jacobian=True, device="cpu")
    assert tp["x"] == pytest.approx(1.0, rel=1e-5)


def test_fit_map_from_an_init_and_without_parameters():
    init = {"mu": 1.0, "sigma": 0.5}
    jp, ji = jopt.fit_map(quickstart(exmc_tpu), init=init)
    tp, ti = topt.fit_map(quickstart(exmc_tpu_torch), init=init, device="cpu")
    assert ti["iters"] == ji["iters"] and ti["converged"] and ji["converged"]
    _close(tp["sigma"], jp["sigma"])
    # a fully observed model: nothing to optimize
    B, D = exmc_tpu_torch.Builder, exmc_tpu_torch.dists
    ir = B.obs(B.rv(B.new_ir(), "y", D.Normal, {"mu": 0.0, "sigma": 1.0}), "y_obs",
               "y", 0.5)
    point, info = topt.fit_map(ir, device="cpu")
    assert point == {} and info["converged"] and info["iters"] == 0
    assert info["logp"] == pytest.approx(-0.5 * 0.25 - 0.5 * np.log(2 * np.pi), rel=1e-6)


@pytest.mark.parametrize("model", ["quickstart", "logistic", "halfnormal_scale"])
def test_laplace_matches_jax(model):
    jt, ji = jopt.laplace(MODELS[model](exmc_tpu), draws=300, seed=5)
    d = ji["z_map"].shape[0]
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(6), (300, d), jnp.float32))
    tt, ti = topt.laplace(MODELS[model](exmc_tpu_torch), draws=300, seed=5, device="cpu",
                          start_noise=start_noise(5, d), noise=eps)
    assert ti["hessian_jitter"] == ji["hessian_jitter"] == 1e-8
    assert ti["iters"] == ji["iters"]
    assert ti["cov_logdet"] == pytest.approx(ji["cov_logdet"], rel=1e-4, abs=1e-4)
    for k in jt:
        assert tt[k].shape == jt[k].shape
        _close(tt[k], jt[k], rtol=5e-4, atol=5e-5)


def cauchy_ridge(pkg):
    B, D = pkg.Builder, pkg.dists
    ir = B.rv(B.new_ir(), "x", D.Normal, {"mu": 0.0, "sigma": 1.0})
    return B.rv(ir, "t", D.Cauchy, {"loc": 0.0, "scale": 1.0})


@pytest.mark.parametrize("t0,want", [(1.01, 1e-2), (0.2, 1e-8)])
def test_laplace_jitter_ladder(t0, want):
    """At t = 1.01 the Cauchy's log-density is convex (curvature ~ +0.01):
    the jitter climbs to 1e-2 before the Cholesky factor exists, as in
    JAX; at t = 0.2 the first jitter does."""
    init = {"x": 0.0, "t": t0}
    _, ji = jopt.laplace(cauchy_ridge(exmc_tpu), init=init, max_iters=0, draws=10)
    _, ti = topt.laplace(cauchy_ridge(exmc_tpu_torch), init=init, max_iters=0, draws=10,
                         device="cpu")
    assert ti["hessian_jitter"] == ji["hessian_jitter"] == want
    assert ti["cov_logdet"] == pytest.approx(ji["cov_logdet"], rel=1e-3)


def test_laplace_refuses_a_convex_point():
    init = {"x": 0.0, "t": 3.0}
    for lap, pkg in ((jopt.laplace, exmc_tpu), (topt.laplace, exmc_tpu_torch)):
        kw = {} if pkg is exmc_tpu else {"device": "cpu"}
        with pytest.raises(ValueError, match="not negative definite"):
            lap(cauchy_ridge(pkg), init=init, max_iters=0, draws=10, **kw)


@pytest.mark.parametrize("name", [
    "halfnormal_scale", "lognormal_conjugate", "mvn_dense_mass", "dirichlet_prior",
    "lkj_marginals", "censored_interval_normal", "ordered_normal_orderstats",
    "mixture_loc", "zero_sum_normal_prior", "truncnorm_loc", "eight_schools_ncp"])
def test_hessian_by_double_backward(name):
    """The Laplace Hessian (the eager log-density's double backward) on
    golds that cover the transforms, the multivariate dists, censoring,
    mixtures and the det ops, against ``jax.hessian``: 1e-4 of the
    largest entry."""
    jm, tm = _compiled(name)
    z = np.random.default_rng(0).uniform(-1, 1, size=tm.size).astype(np.float32)
    want = np.asarray(jax.hessian(lambda q: jm.logp(q, jm.data))(jnp.asarray(z)))
    got = topt.hessian(tm, torch.as_tensor(z)).numpy()
    _close(got, want, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(want).max()))


def test_laplace_psir_matches_jax():
    jt, ji = jopt.laplace(logistic(exmc_tpu), draws=400, seed=2, psir=True)
    d = ji["z_map"].shape[0]
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (400, d), jnp.float32))
    tt, ti = topt.laplace(logistic(exmc_tpu_torch), draws=400, seed=2, psir=True,
                          device="cpu", start_noise=start_noise(2, d), noise=eps)
    assert ti["psir"]["pareto_k"] == pytest.approx(ji["psir"]["pareto_k"], rel=1e-3)
    assert ti["psir"]["ess_is"] == pytest.approx(ji["psir"]["ess_is"], rel=1e-3)
    np.testing.assert_array_equal(ti["psir"]["indices"], ji["psir"]["indices"])
    _close(tt["beta"], jt["beta"], rtol=5e-4, atol=5e-5)


def test_psir_matches_jax_on_the_same_draws():
    jm = jcompile(logistic(exmc_tpu))
    tm = tcompile(logistic(exmc_tpu_torch), device="cpu")
    rng = np.random.default_rng(1)
    mu, sd = np.array([0.3, 1.0, -0.5, 0.8]), np.array([0.4, 0.5, 0.4, 0.45])
    z = (mu + sd * rng.normal(size=(500, 4))).astype(np.float32)
    logq = np.asarray(t_logq(torch.as_tensor(z), torch.as_tensor(mu),
                                             torch.as_tensor(sd)))
    _close(logq, np.asarray(j_logq(z, mu, sd)))
    jt, ji = j_psir(jm, z, logq, seed=9, num_resample=300)
    tt, ti = t_psir(tm, z, logq, seed=9, num_resample=300)
    np.testing.assert_array_equal(ti["indices"], ji["indices"])
    assert ti["pareto_k"] == pytest.approx(ji["pareto_k"], rel=1e-4)
    assert ti["ess_is"] == pytest.approx(ji["ess_is"], rel=1e-4)
    _close(ti["log_weights"], ji["log_weights"], atol=2e-5 * np.abs(ji["log_weights"]).max())
    _close(tt["beta"], jt["beta"])


def test_psir_refuses_bad_inputs():
    tm = tcompile(quickstart(exmc_tpu_torch), device="cpu")
    with pytest.raises(ValueError, match=r"\(S, d\)"):
        t_psir(tm, np.zeros(4, np.float32), np.zeros(4))
    with pytest.raises(ValueError, match="logq has 3 rows"):
        t_psir(tm, np.zeros((4, 2), np.float32), np.zeros(3))
    with pytest.warns(UserWarning, match="tail fit could not run"):
        _, info = t_psir(tm, np.zeros((6, 2), np.float32), np.zeros(6))
    assert np.isnan(info["pareto_k"])


@pytest.mark.parametrize("s,scale", [(100, 1.0), (1000, 2.5), (40, 0.1)])
def test_psis_smooth_matches_jax(s, scale):
    log_w = np.random.default_rng(s).standard_t(3, size=s) * scale
    want = jmc._psis_smooth(log_w.copy())
    got = tmc._psis_smooth(log_w.copy())
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    for fn in (topt.fit_map, topt.laplace):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(quickstart(exmc_tpu_torch))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="cuda"):
            t_psir(quickstart(exmc_tpu_torch), np.zeros((6, 2), np.float32),
                       np.zeros(6))
