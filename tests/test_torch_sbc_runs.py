"""Small SBC runs of the port on the CPU (``exmc_tpu_torch/sbc.py``):

* calibrated runs with NUTS, ChEES and MEADS under the JAX package's
  SBC gates (``benchmarks.post.sbc_gate_failures``: min chi^2 and ECDF
  p > 1e-3, ranks spanning the support, divergence rate < 0.05);
* the mis-specified pair of ``tests/test_sbc.py`` (generator prior
  N(0, 6), fitted prior N(0, 0.5), two observations) detected at
  p < 1e-4, the replications run as one batch of chains over
  per-replication data.
"""

import numpy as np
import pytest

import exmc_tpu_torch
from exmc_tpu_torch import sbc as tsbc
from exmc_tpu_torch.benchmarks import post
from exmc_tpu_torch.nuts.sampler import _make_sampler
from exmc_tpu_torch.predictive import posterior_predictive, prior_samples


SMALL = dict(num_warmup=100, num_samples=150, thin=10, seed=0, device="cpu")


@pytest.mark.parametrize("engine,chains,r", [("nuts", 1, 30), ("chees", 4, 20),
                                             ("meads", 8, 20)])
def test_small_sbc_is_calibrated(engine, chains, r):
    res = tsbc.sbc(post.normal_loc_scale_ir(), num_replications=r, engine=engine,
                   chees_chains=max(chains, 2), **SMALL)
    assert res["L"] == 15 * chains
    assert set(res["ranks"]) == {"mu", "sigma"}
    assert post.sbc_gate_failures(res) == []


def test_misspecified_pair_is_detected():
    """``tests/test_sbc.py::test_sbc_detects_broken_jacobian``: prior
    N(0, 6) generates, prior N(0, 0.5) fits, two observations."""
    B, D = exmc_tpu_torch.Builder, exmc_tpu_torch.dists

    def model(sd):
        ir = B.rv(B.new_ir(), "mu", D.Normal, {"mu": 0.0, "sigma": sd})
        ir = B.rv(ir, "x", D.Normal, {"mu": "mu", "sigma": 1.0}, shape=(2,))
        return B.obs(ir, "x_obs", "x", np.array([1.5, 2.6], np.float32))

    r = 60
    gen, fit = model(6.0), model(0.5)
    prior = prior_samples(gen, num_draws=r, seed=0, device="cpu")
    y = posterior_predictive(gen, {"mu": prior["mu"][None]}, seed=1, device="cpu")
    ir2 = tsbc._data_arg_ir(fit, tsbc._obs_nodes(fit))
    sampler = _make_sampler(ir2, device="cpu", num_warmup=150, num_samples=200,
                            ensemble_rescue=False, pooled_adaptation=False)
    draws, _ = sampler.run(num_chains=r, seed=2, return_unconstrained=True,
                           data=tsbc._replication_data({"x_obs": y["x_obs"][0]}, None,
                                                       "cpu"))
    mu = draws[:, 7::8, 0]  # mu's transform is the identity; L = 25
    ranks = (mu < prior["mu"][:, None]).sum(axis=1)
    _, p = tsbc.rank_uniformity(ranks, L=mu.shape[1])
    assert p < 1e-4
