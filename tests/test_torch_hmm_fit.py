"""The counterparts of ``tests/test_hmm.py``'s NUTS tests on the port, on
the CPU: a Gaussian HMM with its states marginalized recovers its
generating parameters, and smoothing and Viterbi at the posterior-mean
parameters identify the states, with the JAX tests' gates. One fit
serves both (2 chains of 80 + 80, not 400 + 400:
the port's eager sampler on the CPU; the card runs example 42 at its
full settings, ``benchmarks/families.py``)."""

import numpy as np
import pytest
import torch

import exmc_tpu_torch
from exmc_tpu_torch import dists
from exmc_tpu_torch.hmm import hmm_dist, posterior_state_probs, viterbi
from test_torch_families import one_torch_thread  # noqa: F401 (autouse)


def _gen_hmm_data(T=300, seed=0):
    rng = np.random.default_rng(seed)
    trans = np.array([[0.9, 0.1], [0.2, 0.8]])
    mus, sigma = np.array([-1.0, 1.5]), 0.6
    s = np.zeros(T, int)
    for t in range(1, T):
        s[t] = rng.choice(2, p=trans[s[t - 1]])
    y = mus[s] + sigma * rng.normal(size=T)
    return y.astype(np.float32), s, mus, sigma


def _emission(y, k, params):
    z = (y - params["mus"][k]) / params["sigma"]
    return -0.5 * z * z - torch.log(params["sigma"]) - 0.5 * np.log(2 * np.pi)


@pytest.fixture(scope="module")
def fit():
    y, s, mus, sigma = _gen_hmm_data()
    with exmc_tpu_torch.Model() as m:
        m.rv("mus", dists.Normal, {"mu": 0.0, "sigma": 3.0}, transform="ordered", shape=(2,))
        m.rv("sigma", dists.HalfNormal, {"sigma": 2.0})
        m.rv("p00", dists.Beta, {"alpha": 2.0, "beta": 2.0})
        m.rv("p11", dists.Beta, {"alpha": 2.0, "beta": 2.0})
        m.det("trans", lambda a, b: torch.stack([torch.stack([a, 1 - a]),
                                                 torch.stack([1 - b, b])]), ["p00", "p11"])
        m.rv("y", hmm_dist(_emission, 2, stationary_init=True),
             {"trans": "trans", "mus": "mus", "sigma": "sigma"})
        m.obs("y_obs", "y", y)
    trace, stats = exmc_tpu_torch.sample(m.ir, num_chains=2, num_warmup=80,
                                         num_samples=80, seed=0, device="cpu")
    return y, s, mus, sigma, trace, stats


def test_gaussian_hmm_recovers_parameters(fit):
    y, s, mus, sigma, trace, stats = fit
    assert stats["divergences"].sum() == 0
    np.testing.assert_allclose(trace["mus"].reshape(-1, 2).mean(axis=0), mus, atol=0.25)
    assert trace["sigma"].mean() == pytest.approx(sigma, abs=0.1)
    assert trace["p00"].mean() == pytest.approx(0.9, abs=0.08)
    assert trace["p11"].mean() == pytest.approx(0.8, abs=0.1)


def test_hmm_state_decoding(fit):
    y, s, _, _, trace, _ = fit
    p00, p11 = trace["p00"].mean(), trace["p11"].mean()
    params = {"mus": trace["mus"].reshape(-1, 2).mean(axis=0),
              "sigma": trace["sigma"].mean(),
              "trans": np.array([[p00, 1 - p00], [1 - p11, p11]])}
    gamma = posterior_state_probs(_emission, y, params, 2, stationary_init=True,
                                  device="cpu").numpy()
    assert gamma.shape == (len(y), 2)
    np.testing.assert_allclose(gamma.sum(axis=1), 1.0, atol=1e-4)
    assert ((gamma[:, 1] > 0.5).astype(int) == s).mean() > 0.85
    path = viterbi(_emission, y, params, 2, stationary_init=True, device="cpu").numpy()
    assert path.shape == (len(y),)
    assert (path == s).mean() > 0.85
