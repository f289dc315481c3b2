"""End-to-end CPU run of the port's sampler (eight schools, 64 chains,
superchain K=8, 150+200 iterations) against the posterior the JAX
package reaches on the same model, plus the port's diagnostics and trace
constraining held against the JAX package on the same arrays."""

import numpy as np
import pytest
import jax.numpy as jnp

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu import diagnostics as jdiag
from exmc_tpu.nuts import sampler as jsampler
from exmc_tpu_torch import diagnostics as tdiag
from exmc_tpu_torch.nuts import sampler as tsampler
from exmc_tpu_torch.nuts.masked import HostSyncs

Y8 = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
S8 = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]
C, K, WARM, DRAWS = 64, 8, 150, 200


def eight_schools(pkg):
    B, d = pkg.Builder, pkg.dists
    ir = B.new_ir()
    ir = B.rv(ir, "mu", d.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = B.rv(ir, "tau", d.HalfCauchy, {"scale": 5.0})
    for i in range(8):
        ir = B.rv(ir, f"theta_{i}", d.Normal, {"mu": "mu", "sigma": "tau"})
        ir = B.rv(ir, f"y_{i}", d.Normal, {"mu": f"theta_{i}", "sigma": S8[i]})
        ir = B.obs(ir, f"y_{i}_obs", f"y_{i}", Y8[i])
    return ir


@pytest.fixture(scope="module")
def run():
    sampler = tsampler._make_sampler(
        eight_schools(exmc_tpu_torch), device="cpu", num_warmup=WARM,
        num_samples=DRAWS, pooled_adaptation=True)
    draws, stats = sampler.run(num_chains=C, seed=1, init=("superchain", K),
                               return_unconstrained=True)
    return sampler, draws, stats


def test_posterior_and_stats(run):
    sampler, draws, stats = run
    trace = sampler.constrain_trace(draws)
    mu, tau = trace["mu"], trace["tau"]
    assert mu.shape == tau.shape == (C, DRAWS)
    assert abs(mu.mean() - 4.4) < 0.6
    assert abs(tau.mean() - 3.6) < 0.8
    assert float(tdiag.nested_rhat(mu, K)) < 1.05
    assert float(tdiag.nested_rhat(tau, K)) < 1.05
    assert stats["divergences"].sum() / (C * DRAWS) < 0.01
    # the keys and shapes of the JAX package's run (sampler.py:990-996)
    d = sampler.model.size
    want = {"depth": (C, DRAWS), "n_steps": (C, DRAWS),
            "diverging": (C, DRAWS), "accept_prob": (C, DRAWS),
            "energy": (C, DRAWS), "logp": (C, DRAWS), "step_size": (C,),
            "inv_mass": (C, d), "recoveries": (C,), "rescues": (C,),
            "divergences": (C,)}
    # and the port's counts: warmup's steps per chain, and the run's
    # counts that its record lists (host syncs, value-and-grad calls by
    # site, those that ran the GLM likelihood kernel and the leaves that
    # the leaf kernel ran, none here)
    counts = set(HostSyncs.stat_keys(sampler.model.counters))
    assert ({k: v.shape for k, v in stats.items() if k not in counts}
            == dict(want, n_steps_warmup=(C,)))
    assert stats["host_syncs"] == sampler.last_run["host_syncs"]
    assert stats["vag_calls"] == sampler.last_run["vag_calls"]
    assert stats["vag_calls_lik_kernel"] == sampler.last_run["vag_calls_lik_kernel"] == 0
    assert stats["leaf_kernel_leaves"] == sampler.last_run["leaf_kernel_leaves"] == 0
    assert np.isfinite(draws).all() and (stats["step_size"] > 0).all()
    # pooled adaptation gives every chain the same inverse mass
    assert np.allclose(stats["inv_mass"], stats["inv_mass"][:1])
    assert sampler.last_run["host_syncs"] > WARM + DRAWS


def test_trace_matches_jax_constrain(run):
    sampler, draws, _ = run
    got = sampler.constrain_trace(draws)
    ref = jsampler._make_sampler(eight_schools(exmc_tpu)).constrain_trace(draws)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("source", ["trace", "random"])
def test_diagnostics_match_jax(run, source):
    if source == "trace":
        x = run[0].constrain_trace(run[1])["tau"]
    else:
        x = np.random.default_rng(0).normal(size=(16, 50)).cumsum(1).astype(np.float32)
    xj = jnp.asarray(x)
    np.testing.assert_allclose(float(tdiag.ess(x)), float(jdiag.ess(xj)), rtol=1e-3)
    np.testing.assert_allclose(float(tdiag.rhat(x)), float(jdiag.rhat(xj)), rtol=1e-5)
    np.testing.assert_allclose(float(tdiag.nested_rhat(x, 4)),
                               float(jdiag.nested_rhat(xj, 4)), rtol=1e-5)
    np.testing.assert_allclose(tdiag.autocovariance(tdiag._as_2d(x)).numpy(),
                               np.asarray(jdiag.autocovariance(xj)),
                               rtol=1e-3, atol=1e-4 * float(np.var(x)))
