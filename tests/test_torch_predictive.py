"""``predictive`` and ``log_prob`` in the port against the JAX package on
the CPU:

* ``_topo_order`` equals JAX's on models with det chains and NCP;
* ``posterior_predictive``'s likelihood parameters, resolved from every
  draw of one shared trace (NCP, det nodes, an affine ``meas_obs``),
  equal JAX's per-draw resolution (1e-5 relative); its draws and
  ``prior_samples``' agree with JAX's in moments at many draws (within
  5 standard errors of the difference);
* the ordered transform's sorted-iid prior draw, and its error on
  non-scalar params;
* ``ppc_pvalue`` against JAX's at many draws (0.03), and its obs_id
  errors;
* ``log_prob.eval`` equal to JAX's, constrained and not (1e-5).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu import compiler as jcompiler
from exmc_tpu import log_prob as jlog_prob
from exmc_tpu import predictive as jpred
from exmc_tpu_torch import compiler as tcompiler
from exmc_tpu_torch import log_prob as tlog_prob
from exmc_tpu_torch import model_comparison as tmc
from exmc_tpu_torch import predictive as tpred

RTOL = 1e-5
Y8 = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
S8 = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]


def eight_schools(pkg, light_tails=False):
    """Eight schools; ``light_tails`` puts a HalfNormal on tau, so that
    prior moments exist."""
    B, D = pkg.Builder, pkg.dists
    ir = B.rv(B.new_ir(), "mu", D.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = (B.rv(ir, "tau", D.HalfNormal, {"sigma": 5.0}) if light_tails
          else B.rv(ir, "tau", D.HalfCauchy, {"scale": 5.0}))
    ir = B.rv(ir, "theta", D.Normal, {"mu": "mu", "sigma": "tau"}, shape=(8,))
    ir = B.rv(ir, "y", D.Normal, {"mu": "theta", "sigma": np.array(S8)}, shape=(8,))
    return B.obs(ir, "y_obs", "y", np.array(Y8, np.float32))


def det_affine(pkg, exp):
    """A det chain (a scale through ``exp``) and an affine measurable
    observation."""
    B, D = pkg.Builder, pkg.dists
    ir = B.rv(B.new_ir(), "v", D.Normal, {"mu": 0.0, "sigma": 1.0})
    ir = B.det(ir, "s", "exp", ["v"])
    ir = B.det(ir, "s2", lambda s: exp(s) * 0.5, ["s"])
    ir = B.rv(ir, "m", D.Normal, {"mu": 1.0, "sigma": 2.0})
    ir = B.rv(ir, "x", D.Normal, {"mu": "m", "sigma": "s2"}, shape=(3,))
    ir = B.obs(ir, "x_obs", "x", np.array([0.5, 1.5, 2.0], np.float32))
    ir = B.rv(ir, "z", D.Normal, {"mu": "m", "sigma": 1.0}, shape=(2,))
    ir = B.det(ir, "zt", "affine", [2.0, 1.0, "z"])
    return B.obs(ir, "zt_obs", "zt", np.array([3.0, 2.0], np.float32))


def _trace(n=40, seed=0):
    """A constrained (2, n) trace of each model's free RVs."""
    rng = np.random.default_rng(seed)
    es = {"mu": rng.normal(4, 3, (2, n)), "tau": np.exp(rng.normal(1, 0.5, (2, n))),
          "theta": rng.normal(4, 4, (2, n, 8))}
    da = {"v": rng.normal(0, 0.5, (2, n)), "m": rng.normal(1, 1, (2, n))}
    return ({k: v.astype(np.float32) for k, v in es.items()},
            {k: v.astype(np.float32) for k, v in da.items()})


MODELS = {
    "eight_schools": (lambda: eight_schools(exmc_tpu), lambda: eight_schools(exmc_tpu_torch), 0),
    "det_affine": (lambda: det_affine(exmc_tpu, jnp.exp),
                   lambda: det_affine(exmc_tpu_torch, torch.exp), 1),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_topo_order_equals_jax(name):
    jir, tir, _ = MODELS[name]
    for ncp in (False, True):
        j = jpred._topo_order(exmc_tpu.rewrite.apply(jir(), ncp=ncp))
        t = tpred._topo_order(exmc_tpu_torch.rewrite.apply(tir(), ncp=ncp))
        assert j == t


@pytest.mark.parametrize("name", sorted(MODELS))
def test_likelihood_params_equal_jax_per_draw(name):
    jir, tir, which = MODELS[name]
    trace = _trace()[which]
    jm = jcompiler.compile_logp(jir())
    tm = tcompiler.compile_logp(tir(), device="cpu")
    c, n = trace[next(iter(trace))].shape[:2]
    flat = tmc._as_flat_draws(tm, trace)
    lik, _ = tpred._likelihood_params(tm, flat, tm.ir.data)
    names = [e.id for e in jm.pm.entries]
    for i in range(c * n):
        row = {k: trace[k].reshape((c * n,) + trace[k].shape[2:])[i] for k in names}
        jflat = jm.unconstrain(row)
        np.testing.assert_allclose(flat[i].numpy(), np.asarray(jflat), rtol=RTOL, atol=1e-6)
        resolve = jcompiler._make_resolver(jm.ir, jm.pm, jm.pm.unpack(jflat), jm.data)
        for obs_id, (dist, params, shape) in lik.items():
            target = jm.ir.get_node(jm.ir.nodes[obs_id].op[1])
            want = jcompiler._resolve_params(target.op[2], resolve)
            for k, v in want.items():
                got = params[k]
                got = got[i if got.shape[0] > 1 else 0] if got.ndim else got
                np.testing.assert_allclose(np.broadcast_to(got.numpy(), np.shape(v)),
                                           np.asarray(v), rtol=RTOL, atol=1e-6)


def _moments_agree(a, b, k=5.0):
    """Per element, the means agree within k standard errors of their
    difference, and the sds within k standard errors of theirs."""
    a, b = a.reshape(-1, *a.shape[2:]), b.reshape(-1, *b.shape[2:])
    n = a.shape[0]
    se = np.sqrt(a.var(0) / n + b.var(0) / n)
    assert (np.abs(a.mean(0) - b.mean(0)) <= k * se + 1e-6).all()
    se_sd = np.sqrt((a.var(0) + b.var(0)) / (2 * n))
    assert (np.abs(a.std(0) - b.std(0)) <= k * se_sd + 1e-6).all()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_posterior_predictive_moments_agree_with_jax(name):
    jir, tir, which = MODELS[name]
    # one posterior draw repeated: the replicates' moments are exact targets
    trace = {k: np.repeat(v[:1, :1], 4000, axis=1) for k, v in _trace()[which].items()}
    want = jpred.posterior_predictive(jir(), trace, seed=3)
    got = tpred.posterior_predictive(tir(), trace, seed=3, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape
        _moments_agree(got[k], np.asarray(want[k]))


def test_prior_samples_moments_and_ordered_rule():
    want = jpred.prior_samples(eight_schools(exmc_tpu, True), num_draws=4000, seed=1)
    got = tpred.prior_samples(eight_schools(exmc_tpu_torch, True), num_draws=4000, seed=1,
                              device="cpu")
    assert sorted(got) == sorted(want)
    for k in ("mu", "tau", "theta", "y"):
        assert got[k].shape == want[k].shape
        _moments_agree(got[k][None], np.asarray(want[k])[None])
    # ordered: sorted iid draws
    B, D = exmc_tpu_torch.Builder, exmc_tpu_torch.dists
    ir = B.rv(B.new_ir(), "c", D.Normal, {"mu": 0.0, "sigma": 2.0}, shape=(4,),
              transform="ordered")
    draws = tpred.prior_samples(ir, num_draws=500, device="cpu")["c"]
    assert (np.diff(draws, axis=-1) >= 0).all()
    bad = B.rv(B.new_ir(), "c", D.Normal, {"mu": np.arange(4.0), "sigma": 2.0},
               shape=(4,), transform="ordered")
    with pytest.raises(ValueError, match="exchangeable"):
        tpred.prior_samples(bad, num_draws=5, device="cpu")


def test_ppc_pvalue_against_jax():
    trace = {k: np.repeat(v[:1, :1], 3000, axis=1) for k, v in _trace()[0].items()}
    stat = np.max
    want = jpred.ppc_pvalue(eight_schools(exmc_tpu), trace, stat, seed=2)
    got = tpred.ppc_pvalue(eight_schools(exmc_tpu_torch), trace, stat, seed=2,
                           device="cpu")
    assert got["obs_id"] == want["obs_id"] == "y_obs"
    assert got["observed"] == want["observed"]
    assert got["replicated"].shape == want["replicated"].shape
    assert abs(got["p_value"] - want["p_value"]) < 0.03
    trace2 = _trace()[1]
    with pytest.raises(ValueError, match="obs_id"):
        tpred.ppc_pvalue(det_affine(exmc_tpu_torch, torch.exp), trace2, stat, device="cpu")
    with pytest.raises(ValueError, match="unknown obs node"):
        tpred.ppc_pvalue(det_affine(exmc_tpu_torch, torch.exp), trace2, stat,
                         obs_id="nope", device="cpu")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_log_prob_eval_equals_jax(name):
    jir, tir, which = MODELS[name]
    trace = _trace(n=3)[which]
    for i in range(3):
        point = {k: v[0, i] for k, v in trace.items()}
        want = jlog_prob.eval(jir(), point)
        got = tlog_prob.eval(tir(), point, device="cpu")
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
        jm = jcompiler.compile_logp(jir())
        z = {e.id: np.asarray(jm.pm.unpack(jm.unconstrain(point))[e.id])
             for e in jm.pm.entries}
        want = jlog_prob.eval(jm, z, constrained=False)
        got = tlog_prob.eval(tir(), z, constrained=False, device="cpu")
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
