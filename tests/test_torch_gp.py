"""``exmc_tpu_torch.gp`` against the JAX package: the five kernels (and
ARD lengthscales) on the same inputs (relative 1e-6, f32), the latent
and marginal models' log-densities and gradients at random points
(relative 2e-5, 2e-4 for the latent form's gradient through the
Cholesky, applied one point at a time under ``torch.func.vmap``), ``gp_predict`` with the JAX package's
standard normals injected (relative 1e-3: two f32 Cholesky
factorizations per draw), and the counterparts of ``tests/test_gp.py``'s
closed-form, kernel-value and validation tests. The NUTS counterparts
are in ``tests/test_torch_gp_fit.py``."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu import compiler as jcompiler
from exmc_tpu import gp as jgp
from exmc_tpu_torch import dists
from exmc_tpu_torch.gp import KERNELS, gp_latent, gp_marginal, gp_predict, linear, matern32
from exmc_tpu_torch.gp import periodic, rbf
from test_torch_families import one_torch_thread  # noqa: F401 (autouse)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def test_kernel_values():
    x = _t([0.0, 1.0])
    k = rbf(x, x, lengthscale=1.0, variance=2.0).numpy()
    assert k[0, 0] == pytest.approx(2.0)
    assert k[0, 1] == pytest.approx(2.0 * np.exp(-0.5), rel=1e-5)
    a = np.sqrt(3.0)
    assert matern32(x, x).numpy()[0, 1] == pytest.approx((1 + a) * np.exp(-a), rel=1e-4)
    assert periodic(x, x, period=2.0).numpy()[0, 1] == pytest.approx(np.exp(-2.0), rel=1e-5)
    assert linear(x, x, variance=3.0).numpy()[1, 1] == pytest.approx(3.0)
    X2 = _t([[0.0, 0.0], [1.0, 2.0]])
    kard = rbf(X2, X2, lengthscale=_t([1.0, 2.0])).numpy()
    assert kard[0, 1] == pytest.approx(np.exp(-0.5 * (1.0 + 1.0)), rel=1e-5)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernels_match_jax(name):
    rng = np.random.default_rng(0)
    X1 = rng.normal(size=(7, 2)).astype(np.float32)
    X2 = rng.normal(size=(5, 2)).astype(np.float32)
    kw = {"rbf": dict(lengthscale=np.array([0.7, 1.3], np.float32), variance=1.7),
          "matern32": dict(lengthscale=0.9, variance=0.8),
          "matern52": dict(lengthscale=1.1, variance=2.0),
          "periodic": dict(lengthscale=0.8, variance=1.2, period=1.5),
          "linear": dict(variance=0.6, offset=0.3)}[name]
    want = np.asarray(jgp.KERNELS[name](X1, X2, **kw))
    got = KERNELS[name](_t(X1), _t(X2), **{k: (_t(v) if isinstance(v, np.ndarray) else v)
                                           for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def _reg_data(n=30, seed=0):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(-3, 3, n))
    return X, np.sin(2 * X) + 0.2 * rng.normal(size=n)


def _latent_model(pkg, X, yb):
    with pkg.Model() as m:
        m.rv("ls", pkg.dists.HalfNormal, {"sigma": 2.0})
        m.rv("amp", pkg.dists.HalfNormal, {"sigma": 3.0})
        pkg.gp.gp_latent(m, "f", X, kernel="rbf", lengthscale="ls", variance="amp")
        m.rv("yb", pkg.dists.Bernoulli, {"logits": "f"}, shape=(len(X),))
        m.obs("yb_obs", "yb", yb)
    return m.ir


def _marginal_model(pkg, X, y, kernel="rbf"):
    with pkg.Model() as m:
        m.rv("ls", pkg.dists.HalfNormal, {"sigma": 2.0})
        m.rv("amp", pkg.dists.HalfNormal, {"sigma": 2.0})
        m.rv("sn", pkg.dists.HalfNormal, {"sigma": 1.0})
        pkg.gp.gp_marginal(m, "y", X, y, kernel=kernel, lengthscale="ls", variance="amp",
                           noise="sn")
    return m.ir


@pytest.mark.parametrize("form", ["latent", "marginal_rbf", "marginal_matern52"])
def test_gp_models_logp_match_jax(form):
    X, y = _reg_data(n=15, seed=2)
    if form == "latent":
        yb = (y > 0).astype(np.int32)
        jir, tir = _latent_model(exmc_tpu, X, yb), _latent_model(exmc_tpu_torch, X, yb)
    else:
        kern = form.split("_")[1]
        jir, tir = _marginal_model(exmc_tpu, X, y, kern), _marginal_model(exmc_tpu_torch, X, y, kern)
    jc = jcompiler.compile_logp(jir)
    tc = exmc_tpu_torch.compile_logp(tir, device="cpu")
    assert tc.size == jc.size
    x = np.random.default_rng(4).uniform(-1.0, 1.0, size=(4, tc.size)).astype(np.float32)
    jl, jg = jax.vmap(lambda f: jc.value_and_grad(f, jc.data))(jnp.asarray(x))
    tl, tg = tc.value_and_grad(torch.as_tensor(x))
    jl, jg = np.asarray(jl), np.asarray(jg)
    assert (np.abs(tl.numpy() - jl) / np.maximum(1.0, np.abs(jl))).max() < 2e-5
    # the latent form's gradient runs through the Cholesky's backward of
    # a near-singular f32 K: relative 2e-4 there
    tol = 2e-4 if form == "latent" else 2e-5
    assert (np.abs(tg.numpy() - jg) / np.maximum(1.0, np.abs(jg).max(-1, keepdims=True))
            ).max() < tol


@pytest.mark.parametrize("form", ["marginal", "latent"])
def test_gp_predict_matches_jax_with_injected_draws(form):
    rng = np.random.default_rng(5)
    X, y = _reg_data(n=12, seed=5)
    Xs = np.linspace(-2, 2, 9)
    S = 6
    trace = {"ls": rng.uniform(0.6, 1.4, (2, S // 2)), "amp": rng.uniform(0.8, 1.5, (2, S // 2)),
             "sn": rng.uniform(0.2, 0.4, (2, S // 2)), "f_z": rng.normal(size=(2, S // 2, 12))}
    kw = dict(kernel="rbf", lengthscale="ls", variance="amp", seed=3)
    kw.update(dict(y=y, noise="sn") if form == "marginal" else dict(f_name="f"))
    want = jgp.gp_predict(trace, X, Xs, **kw)
    keys = jax.random.split(jax.random.PRNGKey(3), S)
    eps = np.stack([np.asarray(jax.random.normal(k, (len(Xs),), jnp.float32)) for k in keys])
    got = gp_predict(trace, X, Xs, eps=eps, device="cpu", **kw)
    assert got.shape == want.shape == (S, len(Xs))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_gp_predict_matches_closed_form():
    """Degenerate (constant) hyper draws: the predictive mean and sd
    equal the textbook GP regression conditional."""
    X, y = _reg_data(n=20, seed=3)
    Xs = np.linspace(-2, 2, 15)
    ls, amp, sn = 0.8, 1.5, 0.3
    S = 4000
    fs = gp_predict({"ls": np.full((1, S), ls)}, X, Xs, kernel="rbf", lengthscale="ls",
                    variance=amp, noise=sn, y=y, seed=0, device="cpu")
    f64 = torch.float64
    Xt, Xst = torch.tensor(X, dtype=f64), torch.tensor(Xs, dtype=f64)
    kxx = rbf(Xt, Xt, ls, amp).numpy() + 1e-6 * np.eye(len(X))
    kxs = rbf(Xt, Xst, ls, amp).numpy()
    kc = kxx + sn ** 2 * np.eye(len(X))
    mu = kxs.T @ np.linalg.solve(kc, y)
    cov = rbf(Xst, Xst, ls, amp).numpy() + 1e-6 * np.eye(len(Xs)) - kxs.T @ np.linalg.solve(kc, kxs)
    sd = np.sqrt(np.clip(np.diag(cov), 0, None))
    assert np.all(np.abs(fs.mean(0) - mu) < 5 * sd / np.sqrt(S) + 0.02)
    assert np.abs(fs.std(0) - sd).max() < 0.08


def test_gp_validation_errors():
    X, y = _reg_data(n=10)
    trace = {"ls": np.full((1, 5), 1.0)}
    with pytest.raises(ValueError, match="exactly one"):
        gp_predict(trace, X, X, lengthscale="ls", f_name="f", y=y, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        gp_predict(trace, X, X, lengthscale="ls", device="cpu")
    with pytest.raises(ValueError, match="unknown kernel"):
        gp_predict(trace, X, X, kernel="cubic", lengthscale="ls", y=y, noise=0.1, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        gp_predict({}, X, X, lengthscale=1.0, y=y, noise=0.1, device="cpu")


def test_gp_marginal_constant_noise_and_latent_builders():
    X, y = _reg_data(n=8)
    with exmc_tpu_torch.Model() as m:
        m.rv("ls", dists.HalfNormal, {"sigma": 2.0})
        assert gp_marginal(m, "y", X, y, lengthscale="ls", noise=0.3) == "y_obs"
        assert gp_latent(m, "g", X, lengthscale="ls", variance=1.0) == "g"
    model = exmc_tpu_torch.compile_logp(m.ir, device="cpu")
    lp, g = model.value_and_grad(torch.zeros(3, model.size))
    assert torch.isfinite(lp).all() and torch.isfinite(g).all()
