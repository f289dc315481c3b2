"""``exmc_tpu_torch.glm`` against the JAX package: for each of the five
families the same ``glm(m, X, y)`` call builds both packages' models,
whose log-densities and gradients agree at random points (relative
2e-5, f32), and the counterparts of ``tests/test_glm.py``'s tests run on the port
on the CPU with the JAX tests' data and gates (2 chains of 150 + 150,
not 400 + 400: the port's eager sampler on the CPU; the card runs the
JAX tests' recipe, ``benchmarks/families.py``). The robust and count
families' fits are in ``tests/test_torch_glm_fits.py``."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu import compiler as jcompiler
from exmc_tpu.glm import glm as jglm
from exmc_tpu.glm import glm_linpred as jglm_linpred
from exmc_tpu_torch.glm import FAMILIES, glm, glm_linpred
from test_torch_families import one_torch_thread  # noqa: F401 (autouse)

BETA = np.array([1.5, -0.8])
ITERS = 150


def _design(n=200, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 2))
    return rng, X, X @ BETA + 0.5


def _family_data(family):
    rng, X, eta = _design(n=60, seed=4)
    if family in ("normal", "robust"):
        return X, eta + 0.4 * rng.normal(size=len(eta))
    if family == "logistic":
        return X, (rng.uniform(size=len(eta)) < 1 / (1 + np.exp(-eta))).astype(float)
    return X, rng.poisson(np.exp(0.3 * eta)).astype(float)


@pytest.mark.parametrize("family", FAMILIES)
def test_glm_logp_matches_jax(family):
    X, y = _family_data(family)
    with exmc_tpu.Model() as jm:
        jglm(jm, X, y, family=family)
    with exmc_tpu_torch.Model() as tm:
        glm(tm, X, y, family=family)
    jc = jcompiler.compile_logp(jm.ir)
    tc = exmc_tpu_torch.compile_logp(tm.ir, device="cpu")
    assert tc.size == jc.size
    x = np.random.default_rng(1).uniform(-1.0, 1.0, size=(4, tc.size)).astype(np.float32)
    jl, jg = jax.vmap(lambda f: jc.value_and_grad(f, jc.data))(jnp.asarray(x))
    tl, tg = tc.value_and_grad(torch.as_tensor(x))
    jl, jg = np.asarray(jl), np.asarray(jg)
    assert np.abs(tl.numpy() - jl).max() / np.maximum(1.0, np.abs(jl)).max() < 2e-5
    assert (np.abs(tg.numpy() - jg) / np.maximum(1.0, np.abs(jg).max(-1, keepdims=True))
            ).max() < 2e-5


def _fit(family, y, X, **kw):
    with exmc_tpu_torch.Model() as m:
        glm(m, X, y, family=family, **kw)
    return exmc_tpu_torch.sample(m.ir, num_chains=2, num_warmup=ITERS, num_samples=ITERS,
                                 seed=0, device="cpu")


def test_glm_normal():
    rng, X, eta = _design()
    y = eta + 0.4 * rng.normal(size=len(eta))
    trace, stats = _fit("normal", y, X)
    assert stats["divergences"].sum() == 0
    np.testing.assert_allclose(trace["beta"].reshape(-1, 2).mean(axis=0), BETA, atol=0.12)
    assert trace["beta_0"].mean() == pytest.approx(0.5, abs=0.12)
    assert trace["y_sigma"].mean() == pytest.approx(0.4, abs=0.08)


def test_glm_logistic():
    rng, X, eta = _design(n=400)
    y = (rng.uniform(size=len(eta)) < 1 / (1 + np.exp(-eta))).astype(float)
    trace, stats = _fit("logistic", y, X)
    assert stats["divergences"].sum() == 0
    np.testing.assert_allclose(trace["beta"].reshape(-1, 2).mean(axis=0), BETA, atol=0.45)


def test_glm_linpred_and_validation():
    rng, X, eta = _design(n=80)
    y = eta + 0.4 * rng.normal(size=len(eta))
    trace, _ = _fit("normal", y, X)
    Xs = rng.normal(size=(10, 2))
    lp = glm_linpred(trace, Xs, device="cpu")
    assert lp.shape == (2 * ITERS, 10)
    expect = Xs @ trace["beta"].reshape(-1, 2).mean(axis=0) + trace["beta_0"].mean()
    np.testing.assert_allclose(lp.mean(axis=0), expect, atol=1e-3)
    # the JAX package's linear predictor on the same draws
    np.testing.assert_allclose(lp, jglm_linpred(trace, Xs), rtol=1e-5, atol=1e-5)
    with exmc_tpu_torch.Model() as m:
        with pytest.raises(ValueError, match="unknown family"):
            glm(m, X, y, family="gamma")
        with pytest.raises(ValueError, match="rows"):
            glm(m, X, y[:-1])
    assert set(FAMILIES) == {"normal", "robust", "logistic", "poisson", "negbin"}


def test_glm_constant_y_falls_back_to_unit_scales():
    X = np.random.default_rng(0).normal(size=(20, 2))
    y = np.full(20, 3.0)
    with exmc_tpu_torch.Model() as m:
        glm(m, X, y)
    assert m.ir.nodes["beta_0"].op[2]["sigma"] == pytest.approx(2.5)
    assert m.ir.nodes["y_sigma"].op[2]["sigma"] == pytest.approx(2.5)
    assert m.ir.nodes["beta_0"].op[2]["mu"] == pytest.approx(3.0)
