"""WAIC, PSIS-LOO and ``compare`` in the port against the JAX package on
one shared trace (CPU): the pointwise log-likelihood matrix and its
column keys (1e-5 relative), WAIC and LOO with their SEs and k-hats
(1e-4 relative: logsumexps over 800 draws in another order), the
k-hat > 0.7 warning, the plain-IS LOO, and ``compare``'s ranking and
paired SEs; the chunked evaluation equals one pass.
"""

import warnings

import numpy as np
import pytest

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu import model_comparison as jmc
from exmc_tpu_torch import model_comparison as tmc

RTOL = 1e-4


def _normal(pkg, ys):
    B, D = pkg.Builder, pkg.dists
    ir = B.rv(B.new_ir(), "mu", D.Normal, {"mu": 0.0, "sigma": 10.0})
    ir = B.rv(ir, "sigma", D.HalfNormal, {"sigma": 2.0})
    ir = B.rv(ir, "y", D.Normal, {"mu": "mu", "sigma": "sigma"})
    return B.obs(ir, "y_obs", "y", ys)


def _two_obs(pkg, ys):
    """Two observation nodes, one scalar and one vector."""
    B, D = pkg.Builder, pkg.dists
    ir = B.rv(B.new_ir(), "mu", D.Normal, {"mu": 0.0, "sigma": 10.0})
    ir = B.rv(ir, "y", D.Normal, {"mu": "mu", "sigma": 1.0}, shape=(len(ys),))
    ir = B.obs(ir, "y_obs", "y", ys)
    ir = B.rv(ir, "z", D.Normal, {"mu": "mu", "sigma": 2.0})
    return B.obs(ir, "z_obs", "z", np.float32(1.0))


YS = np.random.default_rng(0).normal(1.5, 1.0, 30).astype(np.float32)
YS_BAD = np.concatenate([YS, np.float32([45.0])])


def _trace(seed=0, n=400, bad=False):
    """A (2, n) trace near the posterior of ``_normal`` (of YS_BAD with
    ``bad``)."""
    rng = np.random.default_rng(seed)
    ys = YS_BAD if bad else YS
    return {"mu": rng.normal(ys.mean(), 0.3, (2, n)).astype(np.float32),
            "sigma": np.exp(rng.normal(np.log(ys.std()), 0.12, (2, n))).astype(np.float32)}


def test_pointwise_log_likelihood_equals_jax():
    tr = _trace()
    want, wkeys = jmc.pointwise_log_likelihood(_normal(exmc_tpu, YS), tr)
    got, gkeys = tmc.pointwise_log_likelihood(_normal(exmc_tpu_torch, YS), tr, device="cpu")
    assert gkeys == wkeys and got.shape == want.shape == (800, 30)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    mu = {"mu": tr["mu"]}
    want, wkeys = jmc.pointwise_log_likelihood(_two_obs(exmc_tpu, YS[:4]), mu)
    got, gkeys = tmc.pointwise_log_likelihood(_two_obs(exmc_tpu_torch, YS[:4]), mu,
                                              device="cpu")
    assert gkeys == wkeys == [("y_obs", 0), ("y_obs", 1), ("y_obs", 2), ("y_obs", 3), "z_obs"]
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_pointwise_chunks_equal_one_pass(monkeypatch):
    ir, tr = _normal(exmc_tpu_torch, YS), _trace()
    whole, _ = tmc.pointwise_log_likelihood(ir, tr, device="cpu")
    monkeypatch.setattr(tmc, "POINTWISE_CHUNK", 77)
    chunked, _ = tmc.pointwise_log_likelihood(ir, tr, device="cpu")
    np.testing.assert_array_equal(chunked, whole)


def _close(got, want, keys):
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=RTOL,
                                   atol=1e-4)


def test_waic_and_loo_equal_jax():
    tr = _trace()
    jir, tir = _normal(exmc_tpu, YS), _normal(exmc_tpu_torch, YS)
    _close(tmc.waic(tir, tr, device="cpu"), jmc.waic(jir, tr),
           ("waic", "elpd_waic", "p_waic", "se", "elpd_se", "pointwise"))
    got, want = tmc.loo(tir, tr, device="cpu"), jmc.loo(jir, tr)
    _close(got, want, ("loo", "elpd_loo", "p_loo", "se", "elpd_se", "pointwise",
                       "pareto_k"))
    _close(tmc.loo(tir, tr, psis=False, device="cpu"), jmc.loo(jir, tr, psis=False),
           ("loo", "p_loo", "pointwise"))
    assert "pareto_k" not in tmc.loo(tir, tr, psis=False, device="cpu")


def test_loo_warns_on_large_khat_as_jax_does():
    tr = _trace(bad=True)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = tmc.loo(_normal(exmc_tpu_torch, YS_BAD), tr, device="cpu")
        want = jmc.loo(_normal(exmc_tpu, YS_BAD), tr)
    assert (got["pareto_k"] > 0.7).sum() == (np.asarray(want["pareto_k"]) > 0.7).sum() >= 1
    np.testing.assert_allclose(got["pareto_k"], want["pareto_k"], rtol=RTOL, atol=1e-4)
    assert sum("k-hat" in str(w.message) for w in rec) == 2


@pytest.mark.parametrize("criterion", ["waic", "loo"])
def test_compare_ranks_as_jax(criterion):
    trs = {"good": _trace(1), "off": {"mu": _trace(2)["mu"] + 0.8,
                                      "sigma": _trace(2)["sigma"]}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jmc.compare({k: (_normal(exmc_tpu, YS), v) for k, v in trs.items()},
                           criterion=criterion)
        got = tmc.compare({k: (_normal(exmc_tpu_torch, YS), v) for k, v in trs.items()},
                          criterion=criterion, device="cpu")
    assert [r["name"] for r in got] == [r["name"] for r in want] == ["good", "off"]
    for g, w in zip(got, want):
        assert g["rank"] == w["rank"]
        _close(g, w, ("elpd", "delta_elpd", "delta_elpd_se"))
