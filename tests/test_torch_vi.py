"""ADVI and Pathfinder in the port against the JAX package on the CPU,
with the JAX key discipline's draws injected (``noise=``,
``draw_noise=``, ``start=``, ``elbo_noise=``):

* ADVI: a lockstep of 200 steps of SGD and of Adam (window 20, so the
  early stop is reached inside the run) — mu, sigma, elbo_history,
  converged_at and steps_run match; a step whose log-density is not
  finite is rejected with its optimizer state, as in JAX;
* Pathfinder ``diag`` and ``lowrank`` over 30 iterations: the path
  points from JAX's start; elbo_path, best_iter, mu, sigma and the draws
  from JAX's own path (recorded from its scan); PSIR of the fit's draws;
* ``lowrank_factors``: Q (L - I) Q^T, the log-determinant and the draws
  against JAX's, never Q itself (QR column signs are the library's), also
  for d < 2m;
* ``pathfinder_init``: the best of the per-path fits, as JAX picks it.

Tolerances: 1e-4 relative / 1e-5 absolute in f32 where the arithmetic is
the same; the ELBO path and the log-densities are sums of d or N terms
taken in another order, so they get 1e-4 relative with an absolute
floor of 1e-4 of the values' scale (stated at each use).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu import advi as jadvi
from exmc_tpu import pathfinder as jpf
from exmc_tpu import pathfinder_lowrank as jlr
from exmc_tpu_torch import advi as tadvi
from exmc_tpu_torch import pathfinder as tpf
from exmc_tpu_torch import pathfinder_lowrank as tlr
from exmc_tpu_torch.compiler import compile_logp as tcompile
from exmc_tpu_torch.interop import fit_from_numpy

RTOL, ATOL = 1e-4, 1e-5


def quickstart(pkg):
    B, D = pkg.Builder, pkg.dists
    ys = np.array([2.1, 1.8, 2.5, 2.0, 1.9, 2.3, 2.2, 1.7, 2.4, 2.6], np.float32)
    ir = B.new_ir()
    ir = B.rv(ir, "mu", D.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = B.rv(ir, "sigma", D.HalfNormal, {"sigma": 2.0})
    ir = B.rv(ir, "x", D.Normal, {"mu": "mu", "sigma": "sigma"})
    return B.obs(ir, "x_obs", "x", ys)


def logistic(pkg, n=60, p=3, seed=5):
    B, D = pkg.Builder, pkg.dists
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(0.3 + x @ np.array([1.0, -0.5, 0.8]))))
         ).astype(np.float32)
    ir = B.new_ir()
    ir = B.rv(ir, "alpha", D.Normal, {"mu": 0.0, "sigma": 10.0})
    ir = B.rv(ir, "beta", D.Normal, {"mu": 0.0, "sigma": 10.0}, shape=(p,))
    ir = B.det(ir, "xb", "matmul", [x, "beta"])
    ir = B.det(ir, "eta", "add", ["xb", "alpha"])
    ir = B.rv(ir, "y", D.Bernoulli, {"logits": "eta"}, shape=(n,))
    return B.obs(ir, "y_obs", "y", y)


MODELS = {"quickstart": quickstart, "logistic": logistic}


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def advi_draws(seed, total, num_draws, d):
    """The step noise and draw noise of ``exmc_tpu.advi.advi_fit``."""
    key = jax.random.PRNGKey(seed)
    _, fit_key, draw_key = jax.random.split(key, 3)

    def step(k, _):
        k, kn = jax.random.split(k)
        return k, jax.random.normal(kn, (d,), jnp.float32)

    _, noise = jax.lax.scan(step, fit_key, None, length=total)
    return (np.asarray(noise),
            np.asarray(jax.random.normal(draw_key, (num_draws, d), jnp.float32)))


@pytest.mark.parametrize("model", ["quickstart", "logistic"])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_advi_lockstep(model, optimizer):
    kw = dict(num_steps=200, num_draws=50, window=20, tol=1e-2, seed=3,
              optimizer=optimizer, lr=0.01)
    want = jadvi.advi_fit(MODELS[model](exmc_tpu), **kw)
    d = want["mu"].shape[0]
    noise, draw_noise = advi_draws(3, 200, 50, d)
    got = tadvi.advi_fit(MODELS[model](exmc_tpu_torch), device="cpu", noise=noise,
                         draw_noise=draw_noise, **kw)
    assert got["converged_at"] == want["converged_at"]
    assert got["steps_run"] == want["steps_run"]
    assert got["host_syncs"] == got["steps_run"] // 20
    carried = fit_from_numpy(want, device="cpu")
    assert torch.is_tensor(carried["mu"]) and carried["draws"] is want["draws"]
    _close(got["mu"], carried["mu"])
    _close(got["sigma"], carried["sigma"])
    h_got, h_want = got["elbo_history"], want["elbo_history"]
    np.testing.assert_array_equal(np.isnan(h_got), np.isnan(h_want))
    ran = ~np.isnan(h_want)
    # the ELBO sums N likelihood terms: 1e-4 of its scale
    _close(h_got[ran], h_want[ran], atol=1e-4 * np.abs(h_want[ran]).max())
    for k in want["draws"]:
        _close(got["draws"][k], want["draws"][k])


def test_advi_runs_every_window_without_early_stop():
    kw = dict(num_steps=50, num_draws=10, window=20, seed=0, early_stop=False)
    want = jadvi.advi_fit(quickstart(exmc_tpu), **kw)
    noise, draw_noise = advi_draws(0, 60, 10, 2)
    got = tadvi.advi_fit(quickstart(exmc_tpu_torch), device="cpu", noise=noise,
                         draw_noise=draw_noise, **kw)
    assert got["steps_run"] == want["steps_run"] == 60
    assert got["host_syncs"] == 0
    assert got["elbo_history"].shape == want["elbo_history"].shape == (50,)
    _close(got["mu"], want["mu"])


def exp_chain(pkg):
    """y ~ N(exp(v), 1): a draw of v past ~89 overflows exp in f32, so a
    large step leaves the log-density non-finite and ADVI must reject
    it."""
    B, D = pkg.Builder, pkg.dists
    ir = B.new_ir()
    ir = B.rv(ir, "v", D.Normal, {"mu": 0.0, "sigma": 30.0})
    ir = B.det(ir, "s", "exp", ["v"])
    ir = B.rv(ir, "y", D.Normal, {"mu": "s", "sigma": 1.0}, shape=(3,))
    return B.obs(ir, "y_obs", "y", np.array([5.0, 4.0, 6.0], np.float32))


def test_advi_rejects_a_non_finite_step_with_its_state():
    kw = dict(num_steps=40, num_draws=10, window=20, seed=1, lr=5.0,
              optimizer="adam", early_stop=False)
    want = jadvi.advi_fit(exp_chain(exmc_tpu), **kw)
    noise, draw_noise = advi_draws(1, 40, 10, 1)
    got = tadvi.advi_fit(exp_chain(exmc_tpu_torch), device="cpu", noise=noise,
                         draw_noise=draw_noise, **kw)
    rejected = np.isneginf(want["elbo_history"])
    assert 0 < rejected.sum() < 40, "the case no longer mixes rejected steps"
    np.testing.assert_array_equal(np.isneginf(got["elbo_history"]), rejected)
    assert np.isfinite(got["mu"]).all() and np.isfinite(got["sigma"]).all()
    # steps of size ~5 amplify each rounding difference: 1e-2 relative
    _close(got["mu"], want["mu"], rtol=1e-2)
    _close(got["sigma"], want["sigma"], rtol=1e-2)


def pathfinder_draws(seed, num_iters, k, num_draws, d, lowrank):
    """The start, ELBO noise and draw noise of ``exmc_tpu.pathfinder``."""
    key = jax.random.PRNGKey(seed)
    _, init_key, elbo_key, draw_key = jax.random.split(key, 4)
    start = jax.random.uniform(init_key, (d,), jnp.float32, minval=-2.0, maxval=2.0)
    if lowrank:
        keys = jax.random.split(elbo_key, num_iters)
        eps = jax.vmap(lambda kk: jax.random.normal(kk, (k, d), jnp.float32))(keys)
    else:
        eps = jax.random.normal(elbo_key, (num_iters, k, d), jnp.float32)
    u = jax.random.normal(draw_key, (num_draws, d), jnp.float32)
    return dict(start=np.asarray(start), elbo_noise=np.asarray(eps),
                draw_noise=np.asarray(u))


def jax_fit_and_path(ir, **kw):
    """``exmc_tpu.pathfinder.pathfinder_fit`` with the outputs of its
    L-BFGS scan sent to the host as it runs: (result, path), the path
    carried over by ``interop.fit_from_numpy``."""
    seen = []
    scan = jax.lax.scan

    def spy(f, init, xs, length=None, **k):
        out = scan(f, init, xs, length=length, **k)
        jax.debug.callback(lambda *ys: seen.append(ys), *out[1])
        return out

    jax.lax.scan = spy
    try:
        res = jpf.pathfinder_fit(ir, **kw)
    finally:
        jax.lax.scan = scan
    (ys,) = seen
    names = (("mu", "s", "y", "valid", "gamma") if kw.get("method") == "lowrank"
             else ("mu", "sigma"))
    return res, fit_from_numpy({n: np.asarray(v) for n, v in zip(names, ys)}, device="cpu")


@pytest.mark.parametrize("model", ["quickstart", "logistic"])
@pytest.mark.parametrize("method", ["diag", "lowrank"])
def test_pathfinder_lockstep(model, method):
    """The path from JAX's start, point by point (1e-4 relative, 1e-4
    absolute: coordinates of order 1, one of them crossing 0); then, from JAX's own path, the ELBO path, best_iter, mu,
    sigma and the draws. The ELBOs are compared on JAX's path because
    they are far more sensitive than the path: a point 1e-5 off moves
    the ELBO of a tight fit by up to 1e-2 (the curvature pairs of a
    converged path are rounding noise, which the lowrank factors and the
    diag sigma = 1/sqrt(|grad|) amplify)."""
    lowrank = method == "lowrank"
    kw = dict(num_iters=30, num_draws=40, num_elbo_draws=8, seed=7, method=method)
    want, jpath = jax_fit_and_path(MODELS[model](exmc_tpu), **kw)
    d = want["mu"].shape[0]
    noise = pathfinder_draws(7, 30, 8, 40, d, lowrank)
    tm = tcompile(MODELS[model](exmc_tpu_torch), device="cpu")

    def vag1(x):
        lp, g = tm.value_and_grad(x.unsqueeze(0))
        return lp[0], g[0]

    path = tpf._lbfgs_path(vag1, torch.as_tensor(noise["start"]), 30,
                           tpf.LOWRANK_STEP if lowrank else tpf.ALPHA, lowrank=lowrank)
    _close(path["mu"], jpath["mu"], atol=1e-4)
    if lowrank:
        np.testing.assert_array_equal(path["valid"].numpy(), jpath["valid"].numpy())

    elbos, best, mu, sigma, z, _ = tpf._fit_from_path(
        tm.value_and_grad, jpath, torch.as_tensor(noise["elbo_noise"]),
        torch.as_tensor(noise["draw_noise"]), lowrank)
    assert best == want["best_iter"]
    # the ELBO averages K log-densities of N terms each: 1e-4 of its scale
    _close(elbos, want["elbo_path"], atol=1e-4 * np.abs(want["elbo_path"]).max())
    _close(mu, want["mu"])
    _close(sigma, want["sigma"], rtol=5e-4)
    _close(z, want["draws_unconstrained"][0], rtol=5e-4, atol=1e-4)

    got = tpf.pathfinder_fit(MODELS[model](exmc_tpu_torch), device="cpu", **noise, **kw)
    assert got.get("method") == want.get("method")
    assert got["elbo_path"].shape == (30,) and got["draws"].keys() == want["draws"].keys()


def test_pathfinder_psir_resamples_its_own_draws():
    """``psir=True`` is PSIR of the fit's draws under the lowrank q's
    exact log-density, with the seed + 101 of the JAX package."""
    from exmc_tpu_torch.psir import apply_psir_to_fit

    kw = dict(num_iters=30, num_draws=200, num_elbo_draws=8, seed=2, method="lowrank")
    noise = pathfinder_draws(2, 30, 8, 200, 4, True)
    model = tcompile(logistic(exmc_tpu_torch), device="cpu")
    got = tpf.pathfinder_fit(model, psir=True, **noise, **kw)
    plain = tpf.pathfinder_fit(model, **noise, **kw)
    path = tpf._lbfgs_path(lambda x: tuple(v[0] for v in model.value_and_grad(x[None])),
                           torch.as_tensor(noise["start"]), 30, tpf.LOWRANK_STEP,
                           lowrank=True)
    *_, logq = tpf._fit_from_path(model.value_and_grad, path,
                                  torch.as_tensor(noise["elbo_noise"]),
                                  torch.as_tensor(noise["draw_noise"]), True)
    want = apply_psir_to_fit(plain, model, logq.numpy(), seed=2 + 101)
    np.testing.assert_array_equal(got["psir"]["indices"], want["psir"]["indices"])
    np.testing.assert_array_equal(got["draws"]["beta"], want["draws"]["beta"])
    assert 0 < got["psir"]["ess_is"] <= 200 and np.isfinite(got["psir"]["pareto_k"])


@pytest.mark.parametrize("d,m,n_valid", [(7, 6, 4), (5, 6, 6), (12, 6, 6)])
def test_lowrank_factors_match_jax(d, m, n_valid):
    """d < 2m (k = d) and d > 2m; compared through Q (L - I) Q^T, which no
    sign flip of Q's columns changes."""
    rng = np.random.default_rng(d + m)
    s = rng.normal(size=(m, d)).astype(np.float32)
    # curvature pairs of a positive-definite quadratic: s.y > 0
    a = rng.normal(size=(d, d))
    h = (a @ a.T / d + np.eye(d)).astype(np.float32)
    y = (s @ h).astype(np.float32)
    valid = np.arange(m) >= m - n_valid
    alpha = np.full(d, 0.7, np.float32)
    u = rng.normal(size=(9, d)).astype(np.float32)
    mu = rng.normal(size=d).astype(np.float32)

    jq, jl, jdet = jlr.lowrank_factors(jnp.asarray(alpha), jnp.asarray(s), jnp.asarray(y),
                                       jnp.asarray(valid))
    tq, tl, tdet = tlr.lowrank_factors(torch.as_tensor(alpha), torch.as_tensor(s),
                                       torch.as_tensor(y), torch.as_tensor(valid))
    k = min(d, 2 * m)
    assert tuple(tq.shape) == (d, k) and tuple(tl.shape) == (k, k)
    eye = np.eye(k, dtype=np.float32)
    jq, jl = np.asarray(jq), np.asarray(jl)
    _close(tq.numpy() @ (tl.numpy() - eye) @ tq.numpy().T, jq @ (jl - eye) @ jq.T,
           rtol=1e-3, atol=1e-4)
    _close(float(tdet), float(jdet), rtol=1e-4)

    jx = mu[None] + (u + (u @ jq) @ (jl - eye).T @ jq.T) * np.sqrt(alpha)[None]
    tx, tlogq = tlr.sample_and_logq(torch.as_tensor(u), torch.as_tensor(mu),
                                    torch.as_tensor(alpha), tq, tl, tdet)
    _close(tx.numpy(), jx, rtol=1e-3, atol=1e-4)
    want_logq = -0.5 * (d * np.log(2 * np.pi) + float(jdet) + (u * u).sum(-1))
    _close(tlogq.numpy(), want_logq, rtol=1e-5)
    # the sampled covariance is the factorization's Sigma
    sig = np.asarray(jax.jit(lambda q, l: (q @ (l @ l.T - jnp.eye(k)) @ q.T))(jq, jl))
    sd = tlr.marginal_sd(torch.as_tensor(alpha), tq, tl).numpy()
    _close(sd, np.sqrt(alpha * (1 + np.diag(sig))), rtol=1e-3)


def test_pathfinder_init_picks_the_best_path():
    kw = dict(num_paths=3, num_iters=20)
    want = jpf.pathfinder_init(quickstart(exmc_tpu), 6, seed=4, **kw)
    noise = [pathfinder_draws(4 + 1_000_003 * p, 20, 20, 6, 2, False) for p in range(3)]
    model = tcompile(quickstart(exmc_tpu_torch), device="cpu")
    got = tpf.pathfinder_init(model, 6, seed=4, path_noise=noise, **kw)
    assert got.shape == (6, 2)
    _close(got, want, rtol=5e-4, atol=1e-4)
    # the chosen path is the one with the best ELBO among the solo fits
    fits = [tpf.pathfinder_fit(model, num_iters=20, num_draws=6, num_elbo_draws=20,
                               seed=4 + 1_000_003 * p, **noise[p]) for p in range(3)]
    best = max(fits, key=lambda r: float(np.max(r["elbo_path"])))
    np.testing.assert_array_equal(got, best["draws_unconstrained"][0])


def test_pathfinder_rejects_an_unknown_method():
    with pytest.raises(ValueError, match="unknown pathfinder method"):
        tpf.pathfinder_fit(quickstart(exmc_tpu_torch), device="cpu", method="full")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    for fn in (tadvi.advi_fit, tpf.pathfinder_fit):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(quickstart(exmc_tpu_torch))
