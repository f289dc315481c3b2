"""Chain-level fault recovery in the port (``exmc_tpu/tests/test_fault_recovery.py``
and the fault-injection test of ``test_aux_subsystems.py``).

Two layers, as in the JAX package: in the pipeline, a dead carry (a
non-finite accepted state) re-initializes during warmup and is counted
in ``recoveries``; on the host, ``sample_chains_sharded`` marks dead
chains in ``chain_ok`` and re-dispatches them as a fresh run whose
healthy chains are spliced in. The sharded checks run in one group of
two gloo ranks on the CPU (one torch thread each).
"""

import numpy as np
import pytest
import torch

from exmc_tpu_torch.benchmarks.parallel import (
    SMALL,
    check_fault_redispatch,
    simple_ir,
    start_ranks,
)
from exmc_tpu_torch.compiler import compile_logp
from exmc_tpu_torch.nuts.leapfrog import make_metric
from exmc_tpu_torch.nuts.sampler import (
    NUTSSampler,
    _pipeline_init,
    _pipeline_segment,
    _pipeline_xs,
    sample,
)
from exmc_tpu_torch.nuts.warmup import build_schedule
from exmc_tpu_torch.parallel import make_mesh, sample_chains_sharded
from exmc_tpu_torch.parallel.distributed import _chain_health
from exmc_tpu_torch.utils import FaultInjector

WORLD = 2


def _rank_main(rank):
    """The card task's two checks (a faulted run, a re-dispatch), and a
    run whose log-density is NaN everywhere."""
    mesh = make_mesh(dp=WORLD, device="cpu")
    out = {"task": check_fault_redispatch(rank, mesh, SMALL)}
    killer = FaultInjector(kind="nan", trigger_lo=-1e9, trigger_hi=1e9)
    bad = killer.wrap_model(compile_logp(simple_ir(), device="cpu"))
    trace, stats = sample_chains_sharded(bad, 4, mesh, num_warmup=20, num_samples=10,
                                         seed=2, retry_failed=False)
    out["all_dead"] = (trace["mu"], stats["chain_ok"])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return start_ranks(_rank_main, WORLD, workdir=str(tmp_path_factory.mktemp("pg")),
                       timeout_s=120).wait()


def test_fault_injector_sharded_run_survives(ranks):
    """NaN faults inside the trigger region become divergences; every
    chain on both ranks stays healthy and the posterior is right."""
    for r in ranks:
        t = r["task"]
        assert t["fault_chain_ok"], t
        assert abs(t["fault_mu"] - 2.1) < 0.4


def test_host_redispatch_splices_failed_chain(ranks):
    """Chain 5's record poisoned after warmup: the re-dispatch over both
    ranks replaces it with a healthy retry chain, others untouched."""
    for r in ranks:
        t = r["task"]
        assert t["ok"], t["failures"]
        assert t["redispatched"] == 1 and all(t["chain_ok"])
        assert t["untouched_equal"] and abs(t["retried_mu"] - 2.1) < 0.4


def test_dead_chains_marked_on_every_rank(ranks):
    """A log-density that is NaN everywhere leaves every chain dead;
    with retry_failed=False they stay marked, the same on both ranks."""
    for r in ranks:
        assert not r["all_dead"][1].any()
    np.testing.assert_array_equal(ranks[0]["all_dead"][0], ranks[1]["all_dead"][0])
    assert ranks[0]["task"]["retried_mu"] == ranks[1]["task"]["retried_mu"]


def test_inkernel_recovery_poisoned_chain():
    """A poisoned carry (NaN accepted state) in one of 8 chains is reset
    during warmup and counted; every chain delivers finite draws."""
    model = compile_logp(simple_ir(), device="cpu")
    d = model.size
    vag_fn = model.value_and_grad
    q0 = torch.zeros(8, d) + 0.3
    logp0, grad0 = vag_fn(q0)
    gen = torch.Generator().manual_seed(0)
    carry = _pipeline_init(vag_fn, q0, logp0, grad0, make_metric(torch.ones(8, d)),
                           eps0=torch.full((8,), 0.5), generator=gen)
    q = carry.q.clone()
    q[3] = float("nan")
    logp = carry.logp.clone()
    logp[3] = float("nan")
    carry = carry._replace(q=q, logp=logp)
    xs = _pipeline_xs(build_schedule(60, 6), 20, 6, initial_search=False)
    out, draws, stats = _pipeline_segment(vag_fn, carry, xs, 0.8, 6, True, generator=gen)
    rec = out.recoveries.numpy()
    assert rec[3] >= 1
    assert (rec[np.arange(8) != 3] == 0).all()
    assert torch.isfinite(draws).all() and torch.isfinite(stats["logp"]).all()


def test_recoveries_stat_zero_on_clean_run():
    _, stats = sample(simple_ir(), num_warmup=100, num_samples=50, num_chains=4, seed=0,
                      device="cpu")
    assert (stats["recoveries"] == 0).all()


def test_chain_health_markers():
    logp = np.zeros((4, 50))
    logp[2, 10] = np.nan
    np.testing.assert_array_equal(_chain_health({"logp": logp}), [True, True, False, True])


@pytest.mark.parametrize("kind", ["nan", "inf", "huge_grad"])
def test_fault_injection_recovers(kind):
    """Faults inside the log-density become divergent leaves; the sampler
    completes with finite draws."""
    model = FaultInjector(kind=kind, trigger_lo=3.0, trigger_hi=3.4).wrap_model(
        compile_logp(simple_ir(), device="cpu"))
    trace, _ = NUTSSampler(model=model, num_warmup=100, num_samples=100).run(num_chains=2,
                                                                            seed=0)
    assert np.isfinite(trace["mu"]).all()
    assert abs(float(trace["mu"].mean()) - 2.1) < 0.4


@pytest.mark.parametrize("kind", ["nan", "inf", "huge_grad"])
def test_fault_injector_wrap_matches_jax(kind):
    """The wrapped value-and-grad of the same points equals the JAX
    injector's: the fault fires on the chains with a coordinate in the
    region, and only there."""
    import jax
    import jax.numpy as jnp

    import exmc_tpu
    from exmc_tpu.utils import FaultInjector as JaxInjector

    pts = np.array([[0.1, 2.0], [0.45, 0.2], [-1.0, 3.0], [0.6, 0.7]], np.float32)

    def vag_t(q):
        return -0.5 * (q ** 2).sum(-1), -q

    def vag_j(q):
        return -0.5 * jnp.sum(q ** 2), -q

    got_v, got_g = FaultInjector(kind=kind).wrap(vag_t)(torch.as_tensor(pts))
    want = [jax.device_get(JaxInjector(kind=kind).wrap(vag_j)(jnp.asarray(p))) for p in pts]
    np.testing.assert_array_equal(got_v.numpy(), np.array([v for v, _ in want]))
    np.testing.assert_array_equal(got_g.numpy(), np.stack([g for _, g in want]))
    assert exmc_tpu  # the JAX package's injector, imported above


def test_ensemble_rescue_teleports_outlier_chain():
    """At a rescue checkpoint a chain hundreds of nats below the others
    adopts the 75th-percentile chain's state (jittered) and metric;
    healthy chains are untouched."""
    from exmc_tpu_torch import Builder, dists

    ys = np.array([1.0, 1.4, 0.6, 1.1, 0.9, 1.2, 0.8, 1.3], np.float32)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = Builder.rv(ir, "x", dists.Normal, {"mu": "mu", "sigma": 0.3}, shape=(8,))
    ir = Builder.obs(ir, "x_obs", "x", ys)
    model = compile_logp(ir, ncp=False, device="cpu")
    vag_fn = model.value_and_grad
    d = model.size
    q0 = torch.zeros(6, d)
    q0[2, 0] = 150.0
    logp, grad = vag_fn(q0)
    gen = torch.Generator().manual_seed(0)
    carry = _pipeline_init(vag_fn, q0, logp, grad, make_metric(torch.ones(6, d)),
                           eps0=torch.full((6,), 0.05), generator=gen)
    xs = (np.zeros(2, bool), np.zeros(2, bool), np.full(2, 4, np.int32), np.ones(2, bool),
          np.zeros(2, bool), np.array([False, True]), np.arange(2, dtype=np.int32))
    out, _, _ = _pipeline_segment(vag_fn, carry, xs, 0.8, 4, True, rescue=True, generator=gen)
    assert out.rescues.tolist() == [0, 0, 1, 0, 0, 0]
    assert abs(float(out.q[2, 0])) < 10.0
