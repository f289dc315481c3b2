"""The counterpart of ``tests/test_gp.py``'s marginal-regression NUTS
test on the port, on the CPU: the marginal GP regression recovers the
noise and predicts the truth, with the JAX test's data and gates (2
chains of 150 + 150, not 400 + 400: the port's eager sampler on the CPU;
the card runs example 41 at its full settings,
``benchmarks/families.py``). The latent classifier is in
``tests/test_torch_gp_latent.py``."""

import numpy as np
import pytest

import exmc_tpu_torch
from exmc_tpu_torch import dists
from exmc_tpu_torch.diagnostics import rhat
from exmc_tpu_torch.gp import gp_marginal, gp_predict
from test_torch_families import one_torch_thread  # noqa: F401 (autouse)


def _reg_data(n=30, seed=0):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(-3, 3, n))
    return X, np.sin(2 * X) + 0.2 * rng.normal(size=n)


def test_gp_marginal_regression_and_predict():
    X, y = _reg_data()
    with exmc_tpu_torch.Model() as m:
        m.rv("ls", dists.HalfNormal, {"sigma": 2.0})
        m.rv("amp", dists.HalfNormal, {"sigma": 2.0})
        m.rv("sn", dists.HalfNormal, {"sigma": 1.0})
        gp_marginal(m, "y", X, y, kernel="rbf", lengthscale="ls", variance="amp", noise="sn")
    trace, stats = exmc_tpu_torch.sample(m.ir, num_chains=2, num_warmup=150,
                                         num_samples=150, seed=0, device="cpu")
    assert stats["divergences"].sum() == 0
    assert trace["sn"].mean() == pytest.approx(0.2, abs=0.12)
    assert rhat(trace["ls"]) < 1.1
    Xs = np.linspace(-2.5, 2.5, 40)
    fs = gp_predict(trace, X, Xs, kernel="rbf", lengthscale="ls", variance="amp",
                    noise="sn", y=y, num_draws=200, device="cpu")
    assert fs.shape == (200, 40)
    assert np.isfinite(fs).all()
    assert np.abs(fs.mean(0) - np.sin(2 * Xs)).mean() < 0.2
