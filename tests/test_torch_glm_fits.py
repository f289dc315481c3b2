"""The counterparts of ``tests/test_glm.py``'s robust and count-family
tests on the port, on the CPU, with the JAX tests' data and gates (2
chains of 150 + 150, not 400 + 400; see ``tests/test_torch_glm.py``)."""

import numpy as np
import pytest

import exmc_tpu_torch
from exmc_tpu_torch.glm import glm
from test_torch_families import one_torch_thread  # noqa: F401 (autouse)

BETA = np.array([1.5, -0.8])
ITERS = 150


def _design(n=200, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 2))
    return rng, X, X @ BETA + 0.5


def _fit(family, y, X, **kw):
    with exmc_tpu_torch.Model() as m:
        glm(m, X, y, family=family, **kw)
    return exmc_tpu_torch.sample(m.ir, num_chains=2, num_warmup=ITERS, num_samples=ITERS,
                                 seed=0, device="cpu")


def test_glm_robust_vs_outliers():
    rng, X, eta = _design()
    y = eta + 0.4 * rng.normal(size=len(eta))
    y[:8] += 25.0  # gross outliers
    trace_r, _ = _fit("robust", y, X)
    np.testing.assert_allclose(trace_r["beta"].reshape(-1, 2).mean(axis=0), BETA, atol=0.15)
    trace_n, _ = _fit("normal", y, X)
    assert trace_r["y_sigma"].mean() < trace_n["y_sigma"].mean() / 2


def test_glm_poisson_and_negbin():
    rng, X, _ = _design(n=300, seed=1)
    eta = X @ np.array([0.6, -0.3]) + 1.0
    y = rng.poisson(np.exp(eta)).astype(float)
    trace, stats = _fit("poisson", y, X)
    assert stats["divergences"].sum() == 0
    np.testing.assert_allclose(trace["beta"].reshape(-1, 2).mean(axis=0), [0.6, -0.3],
                               atol=0.12)
    lam = np.exp(eta) * rng.gamma(2.0, 1 / 2.0, size=len(eta))
    trace2, _ = _fit("negbin", rng.poisson(lam).astype(float), X)
    np.testing.assert_allclose(trace2["beta"].reshape(-1, 2).mean(axis=0), [0.6, -0.3],
                               atol=0.2)
    assert trace2["y_alpha"].mean() == pytest.approx(2.0, abs=1.2)
