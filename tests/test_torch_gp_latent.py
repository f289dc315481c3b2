"""The counterpart of ``tests/test_gp.py``'s latent-classification NUTS
test on the port, on the CPU: the whitened latent GP classifier (its
Cholesky applied one point at a time) samples without divergences and
predicts the decision boundary, with the JAX test's data and gates (2
chains of 150 + 150, not 600 + 500: the port's eager sampler on the
CPU; the card runs example 41 at its full settings,
``benchmarks/families.py``)."""

import numpy as np

import exmc_tpu_torch
from exmc_tpu_torch import dists
from exmc_tpu_torch.diagnostics import rhat
from exmc_tpu_torch.gp import gp_latent, gp_predict
from test_torch_families import one_torch_thread  # noqa: F401 (autouse)


def test_gp_latent_classification():
    rng = np.random.default_rng(0)
    n = 40
    X = np.sort(rng.uniform(-3, 3, n))
    p_true = 1 / (1 + np.exp(-3 * np.sin(2 * X)))
    yb = (rng.uniform(size=n) < p_true).astype(np.int32)
    with exmc_tpu_torch.Model() as m:
        m.rv("ls", dists.HalfNormal, {"sigma": 2.0})
        m.rv("amp", dists.HalfNormal, {"sigma": 3.0})
        gp_latent(m, "f", X, kernel="rbf", lengthscale="ls", variance="amp")
        m.rv("yb", dists.Bernoulli, {"logits": "f"}, shape=(n,))
        m.obs("yb_obs", "yb", yb)
    trace, stats = exmc_tpu_torch.sample(m.ir, num_chains=2, num_warmup=150,
                                         num_samples=150, seed=1, target_accept=0.9,
                                         device="cpu")
    assert stats["divergences"].sum() == 0
    assert rhat(trace["ls"]) < 1.05
    Xs = np.linspace(-3, 3, 50)
    fs = gp_predict(trace, X, Xs, kernel="rbf", lengthscale="ls", variance="amp",
                    f_name="f", jitter=1e-4, num_draws=200, device="cpu")
    agree = (((1 / (1 + np.exp(-fs))).mean(0) > 0.5) == (np.sin(2 * Xs) > 0)).mean()
    assert agree > 0.85
    assert np.isfinite(fs).all()
