"""The port's parallel package (``exmc_tpu_torch.parallel``) and
``sample_chees(mesh=...)``, against the JAX package on the conftest's
8-device mesh and against its own unsharded runs.

One group of four gloo ranks on the CPU (one torch thread each) runs
every multi-rank check, over two meshes: dp 2 x sp 2 and dp 4 x sp 1.
JAX is imported only by the tests, never by the ranks. Tolerances: the
data-parallel value and gradient within 1e-5 relative of JAX's (f32 sums
in another order); the dryrun recipe's posterior in distribution (means
within 0.3 posterior sds, sds within 25 %: two runs of 16 chains x 50
draws); bit for bit where the port promises it (one rank; no pooling, no
rescue); a merged Welford state within 1e-6 relative of one process's.
"""

import numpy as np
import pytest
import torch

import exmc_tpu_torch
from exmc_tpu_torch import Builder, dists
from exmc_tpu_torch.benchmarks.parallel import gaussian8_ir, simple_ir, start_ranks
from exmc_tpu_torch import chees
from exmc_tpu_torch.chees import run_groups, sample_chees, sample_snaper
from exmc_tpu_torch.compiler import compile_logp
from exmc_tpu_torch.marginal import sv_marginal_model
from exmc_tpu_torch.nuts.masked import HostSyncs
from exmc_tpu_torch.nuts.step_size import da_finalize
from exmc_tpu_torch.nuts.leapfrog import make_metric
from exmc_tpu_torch.nuts.mass_matrix import WelfordState, welford_merge_across
from exmc_tpu_torch.nuts.sampler import NUTSSampler, _find_valid_init, _rescue
from exmc_tpu_torch.parallel import (
    data_parallel_vag,
    make_mesh,
    sample_chains_sharded,
    shard_chains,
)
from exmc_tpu_torch.parallel.distributed import RANK_SEED_STRIDE

WORLD = 4
DRYRUN = dict(num_warmup=50, num_samples=50, max_tree_depth=6, pooled_adaptation=True)
VAG_POINTS = np.linspace(-1.0, 1.5, 8, dtype=np.float32)


def _logistic_data(n_rows=64, seed=0):
    """``tests/test_parallel.py::_logistic_ir``'s rows (x, y), d = 3."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_rows, 3)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(x @ np.array([1.0, -0.5, 0.25], np.float32))))
    y = (rng.random(n_rows) < p).astype(np.float32)
    return np.concatenate([x, y[:, None]], axis=1)


def _torch_loglik(beta, params, data=None):
    xm, yv = data[0, :, :-1], data[0, :, -1]
    logits = beta @ xm.T
    return torch.sum(yv * logits - torch.nn.functional.softplus(logits), dim=-1)


def _logistic_ir(pkg, loglik):
    ir = pkg.Builder.new_ir()
    ir = pkg.Builder.rv(ir, "beta", pkg.dists.Custom(logpdf_fn=loglik, support="real"), {},
                        shape=(3,))
    return pkg.Builder.data(ir, _logistic_data())


def _normal_obs_ir(pkg):
    """``tests/test_parallel.py::test_data_parallel_vag_matches``'s model."""
    data = np.random.default_rng(0).normal(1.0, 1.0, size=(64,)).astype(np.float32)
    ir = pkg.Builder.new_ir()
    ir = pkg.Builder.rv(ir, "mu", pkg.dists.Normal, {"mu": 0.0, "sigma": 10.0})
    ir = pkg.Builder.rv(ir, "y", pkg.dists.Normal, {"mu": "mu", "sigma": 1.0})
    ir = pkg.Builder.obs(ir, "y_obs", "y", "__obs_data")
    return pkg.Builder.data(ir, data), data


def _rank_main(rank):
    out = {"world": torch.distributed.get_world_size(),
           "backend": torch.distributed.get_backend()}
    m22 = make_mesh(dp=2, sp=2, device="cpu")
    m41 = make_mesh(dp=4, sp=1, device="cpu")
    out["shapes"] = (m22.shape, m41.shape)

    # the dryrun's recipe at dp 2 x sp 2
    trace, stats = sample_chains_sharded(_logistic_ir(exmc_tpu_torch, _torch_loglik), 16,
                                         m22, seed=0, **DRYRUN)
    out["dryrun_beta"] = trace["beta"]
    out["dryrun_stats"] = {k: stats[k] for k in ("divergences", "inv_mass", "chain_ok")}

    # data-parallel value and gradient over sp = 2 at 8 points
    q = torch.as_tensor(VAG_POINTS[:, None])
    ir, data = _normal_obs_ir(exmc_tpu_torch)
    vag, shard = data_parallel_vag(compile_logp(ir, device="cpu"), m22, data)
    out["vag_normal"] = [t.numpy() for t in vag(q)]
    out["shard_rows"] = shard.leaves()[0].shape[1]
    lir = _logistic_ir(exmc_tpu_torch, _torch_loglik)
    vag, _ = data_parallel_vag(compile_logp(lir, device="cpu"), m22, lir.data)
    out["vag_logistic"] = [t.numpy() for t in vag(q.expand(8, 3) * torch.tensor([1., -1., .5]))]

    # no pooling, no rescue: this rank's chains are the unsharded run of
    # 4 chains at its seed, bit for bit
    opts = dict(num_warmup=40, num_samples=20, pooled_adaptation=False,
                ensemble_rescue=False)
    trace, _ = sample_chains_sharded(simple_ir(), 16, m41, seed=7, **opts)
    ref, _ = NUTSSampler(model=compile_logp(simple_ir(), device="cpu"), **opts).run(
        num_chains=4, seed=7 + rank * RANK_SEED_STRIDE)
    out["no_pool_equal"] = bool(np.array_equal(trace["mu"][4 * rank:4 * rank + 4], ref["mu"]))
    out["shard_chains"] = shard_chains(m41, np.arange(16.0), np.arange(32.0).reshape(16, 2))

    # the pooled Welford merge over 4 ranks
    state = _welford_state()
    mine = m41.axis("dp").block(16)
    merged = welford_merge_across(WelfordState(*(f[mine] for f in state)),
                                  m41.axis("dp"))
    out["merged"] = [t.numpy() for t in merged]

    # the rescue's 75th-percentile chain sits on rank 3
    q = torch.as_tensor(RESCUE_Q[2 * rank:2 * rank + 2, None])
    inv = torch.as_tensor(1.0 + np.arange(2 * rank, 2 * rank + 2, dtype=np.float32)[:, None])

    def vag_fn(x):
        return -0.5 * (x ** 2).sum(-1), -x

    logp, grad = vag_fn(q)
    gen = torch.Generator().manual_seed(rank)
    rq, _, _, rmetric, rescues = _rescue(vag_fn, q, logp, grad, make_metric(inv),
                                         torch.zeros(2, dtype=torch.int32), gen,
                                         m41.axis("dp"))
    out["rescue"] = (rq.numpy(), rmetric.inv.numpy(), rescues.numpy())

    # the refusals, on every rank
    errors = {}
    for name, call in (
            ("uneven", lambda: sample_chains_sharded(simple_ir(), 6, m41, num_warmup=10,
                                                     num_samples=10)),
            ("no_data", lambda: sample_chains_sharded(simple_ir(), 8, m22, num_warmup=10,
                                                      num_samples=10)),
            ("chees_uneven", lambda: sample_chees(gaussian8_ir(), num_chains=6, mesh=m41))):
        try:
            call()
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors

    # the init search redraws rank 2's chains only; every rank's generator
    # stays in step with the one-process run's
    gen = torch.Generator().manual_seed(3)
    rows = m41.axis("dp").block(16)
    q_init, _, _ = _find_valid_init(_half_space_vag, torch.as_tensor(INIT_Q[rows]), gen,
                                    group=m41.axis("dp"))
    out["init"] = (q_init.numpy(), torch.randn(16, 2, generator=gen)[rows].numpy())

    # ChEES and SNAPER over dp = 4 (sample_chees raises if the ranks' L
    # part); the tuning and L of 8 warmup iterations with a mass window
    model = compile_logp(gaussian8_ir(), device="cpu")
    for name, fn in (("chees", sample_chees), ("snaper", sample_snaper)):
        trace, stats = fn(gaussian8_ir(), num_chains=16, num_warmup=50, num_samples=50,
                          seed=2, mesh=m41)
        outs, carry, _ = run_groups(model, None, 1, 16, 8, 0, 2, name, group=m41.axis("dp"),
                                    kernel=_window_kernel())
        out[name] = {"L": outs["num_steps"][:, 0], "step_size": stats["step_size"],
                     "x_sd": trace["x"].reshape(-1, 8).std(axis=0),
                     "divergences": int(stats["divergences"].sum()),
                     "tuning": _tuning(carry)}
    try:  # rank 2 read another L at the third iteration
        chees._check_lockstep(np.array([3, 4, 5 + (rank == 2)]), m41.axis("dp"))
    except RuntimeError as e:
        out["lockstep_error"] = str(e)
    return out


def _window_kernel():
    """8 warmup iterations whose mass window closes at iteration 4, so
    that the pooled merge runs before rounding differences can grow."""
    kernel = chees._Kernel(8, 0)
    kernel.update_mass = np.arange(8) <= 4
    kernel.window_end = np.arange(8) == 4
    return kernel


def _tuning(carry):
    out = {"step_size": da_finalize(carry["da"])[0], "log_t": carry["logT"][0],
           "trajectory_length": torch.exp(carry["logT_bar"])[0], "inv_mass": carry["inv"][0]}
    if "pc" in carry:
        out["pc"] = carry["pc"][0]
    return {k: v.numpy() for k, v in out.items()}


# the init points of 16 chains in 2-d, 4 a rank: rank 2's sit outside the
# support of ``_half_space_vag`` (x0 < 1)
INIT_Q = np.zeros((16, 2), np.float32)
INIT_Q[8:12, 0] = 5.0


def _half_space_vag(x):
    inside = x[:, 0] < 1.0
    logp = torch.where(inside, -0.5 * (x ** 2).sum(-1), torch.full_like(x[:, 0], -np.inf))
    return logp, -x


# global chain i of 8 (2 a rank) sits at q = RESCUE_Q[i]; chain 0 is 5000
# nats down, and the 75th-percentile chain (index 6 ascending) is chain 6
RESCUE_Q = np.array([100.0, 3.0, 2.9, 2.8, 2.0, 1.9, 0.5, 0.2], np.float32)


def _welford_state():
    rng = np.random.default_rng(11)
    n = rng.integers(5, 40, size=16).astype(np.float32)
    mean = (rng.normal(size=(16, 3)) * 0.5 + 1e3).astype(np.float32)
    m2 = (rng.uniform(0.5, 2.0, size=(16, 3)) * n[:, None]).astype(np.float32)
    return WelfordState(torch.as_tensor(n), torch.as_tensor(mean), torch.as_tensor(m2))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    run = start_ranks(_rank_main, WORLD, workdir=str(tmp_path_factory.mktemp("pg")),
                      timeout_s=120)
    try:
        jax_ref = _jax_reference()
    except BaseException:
        run.kill()
        raise
    return run.wait(), jax_ref


def _jax_reference():
    import jax
    import jax.numpy as jnp

    import exmc_tpu
    from exmc_tpu.parallel import data_parallel_vag as jax_dp_vag
    from exmc_tpu.parallel import make_mesh as jax_mesh
    from exmc_tpu.parallel import sample_chains_sharded as jax_sharded

    def loglik(beta, params, data=None):
        xm, yv = data[:, :-1], data[:, -1]
        logits = xm @ beta
        return jnp.sum(yv * logits - jnp.logaddexp(0.0, logits))

    out = {}
    trace, stats = jax_sharded(_logistic_ir(exmc_tpu, loglik), 16,
                               jax_mesh(8, dp=4, sp=2), seed=0, **DRYRUN)
    out["dryrun_beta"] = np.asarray(trace["beta"])
    out["dryrun_divergences"] = np.asarray(stats["divergences"])
    mesh = jax_mesh(8, dp=4, sp=2)
    ir, data = _normal_obs_ir(exmc_tpu)
    vag, _ = jax_dp_vag(exmc_tpu.compile_logp(ir), mesh, jnp.asarray(data))
    vals = [vag(jnp.asarray([p])) for p in VAG_POINTS]
    out["vag_normal"] = [np.array([float(v) for v, _ in vals]),
                         np.stack([np.asarray(g) for _, g in vals])]
    lir = _logistic_ir(exmc_tpu, loglik)
    vag, _ = jax_dp_vag(exmc_tpu.compile_logp(lir), mesh, jnp.asarray(lir.data))
    pts = VAG_POINTS[:, None] * np.array([1.0, -1.0, 0.5], np.float32)
    vals = [jax.device_get(vag(jnp.asarray(p))) for p in pts]
    out["vag_logistic"] = [np.array([float(v) for v, _ in vals]),
                           np.stack([np.asarray(g) for _, g in vals])]
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_group_formed_by_initialize_distributed(ranks):
    results, _ = ranks
    assert [r["world"] for r in results] == [WORLD] * WORLD
    assert {r["backend"] for r in results} == {"gloo"}
    assert results[0]["shapes"] == ({"dp": 2, "sp": 2}, {"dp": 4, "sp": 1})


@pytest.mark.parametrize("model", ["vag_normal", "vag_logistic"])
def test_data_parallel_vag_matches_jax(ranks, model):
    """sp = 2: every rank's value and gradient equal JAX's
    ``data_parallel_vag`` at the same points (the logistic one's prior is
    the flat default; the normal one's prior counted once)."""
    results, jax_ref = ranks
    for r in results:
        assert _rel(r[model][0], jax_ref[model][0]) < 1e-5
        assert _rel(r[model][1], jax_ref[model][1]) < 1e-5
    assert results[0]["shard_rows"] == 32


def test_dryrun_recipe_matches_jax_in_distribution(ranks):
    """The dryrun's recipe (logistic, 16 chains, 50 + 50, depth 6, pooled)
    at dp 2 x sp 2 against JAX's at dp 4 x sp 2."""
    results, jax_ref = ranks
    beta = results[0]["dryrun_beta"]
    for r in results[1:]:
        np.testing.assert_array_equal(r["dryrun_beta"], beta)
    assert beta.shape == jax_ref["dryrun_beta"].shape == (16, 50, 3)
    assert np.isfinite(beta).all()
    st = results[0]["dryrun_stats"]
    assert st["chain_ok"].all() and st["divergences"].sum() <= 16
    mine, ref = beta.reshape(-1, 3), jax_ref["dryrun_beta"].reshape(-1, 3)
    sd = ref.std(axis=0)
    assert (np.abs(mine.mean(axis=0) - ref.mean(axis=0)) < 0.3 * sd).all()
    assert (np.abs(mine.std(axis=0) / sd - 1.0) < 0.25).all()
    from exmc_tpu_torch.diagnostics import rhat
    assert max(float(rhat(beta[:, :, i])) for i in range(3)) < 1.2


def test_no_pooling_rank_runs_equal_unsharded_runs(ranks):
    """Without pooling or rescue rank r's chains are the unsharded run of
    C / W chains at seed + r * RANK_SEED_STRIDE, bit for bit."""
    results, _ = ranks
    assert all(r["no_pool_equal"] for r in results)


def test_shard_chains_gives_each_rank_its_block(ranks):
    results, _ = ranks
    for rank, r in enumerate(results):
        a, b = r["shard_chains"]
        np.testing.assert_array_equal(a.numpy(), np.arange(4.0 * rank, 4.0 * rank + 4))
        assert tuple(b.shape) == (4, 2)


def test_pooled_inv_mass_equal_across_ranks_and_chains(ranks):
    """The dryrun's pooled adaptation: one inverse mass for the 16 chains
    of the two dp ranks, the same on all four ranks."""
    results, _ = ranks
    inv = results[0]["dryrun_stats"]["inv_mass"]
    assert inv.shape == (16, 3)
    np.testing.assert_array_equal(inv, np.broadcast_to(inv[:1], inv.shape))
    for r in results[1:]:
        np.testing.assert_array_equal(r["dryrun_stats"]["inv_mass"], inv)


def test_cross_rank_welford_merge_equals_one_process_merge(ranks):
    """The two-pass centred merge over 4 ranks (means near 1e3) equals
    the one-process merge of all 16 chains within 1e-6 relative."""
    results, _ = ranks
    ref = welford_merge_across(_welford_state())
    for r in results:
        for got, want in zip(r["merged"], ref):
            assert _rel(got, want.numpy()) < 1e-6


def test_rescue_takes_the_percentile_chain_of_another_rank(ranks):
    results, _ = ranks
    q0, inv0, res0 = results[0]["rescue"]
    assert res0.tolist() == [1, 0]
    assert abs(float(q0[0, 0]) - RESCUE_Q[6]) < 0.05  # rank 3's chain 6, jittered
    assert float(inv0[0, 0]) == 7.0 and float(inv0[1, 0]) == 2.0
    assert float(q0[1, 0]) == RESCUE_Q[1]
    for r in results[1:]:
        q, inv, res = r["rescue"]
        assert res.tolist() == [0, 0]


def test_sharded_refusals_on_every_rank(ranks):
    results, _ = ranks
    for r in results:
        assert "not divisible" in r["errors"]["uneven"]
        assert "Builder.data" in r["errors"]["no_data"]
        assert "not divisible by dp=4" in r["errors"]["chees_uneven"]


@pytest.mark.parametrize("engine", ["chees", "snaper"])
def test_chees_mesh_runs_lockstep_over_ranks(ranks, engine):
    """``mesh=`` over dp = 4: the 50 + 50 run returns (it checks that
    every rank read the same L every iteration) with the same tuning on
    every rank and recovers the sds; the 8-iteration run's L, seen
    directly, are the same on every rank."""
    results, _ = ranks
    first = results[0][engine]
    for r in results[1:]:
        np.testing.assert_array_equal(r[engine]["L"], first["L"])
        np.testing.assert_array_equal(r[engine]["step_size"], first["step_size"])
    assert len(first["L"]) == 8 and first["divergences"] == 0
    np.testing.assert_allclose(first["x_sd"], np.linspace(1.0, 8.0, 8), rtol=0.3)


def test_lockstep_check_raises_on_every_rank(ranks):
    """One rank's L differ at the third iteration: every rank raises
    (none is left waiting in a collective), naming the iteration."""
    results, _ = ranks
    for r in results:
        assert "from iteration 2 on" in r["lockstep_error"]


@pytest.mark.parametrize("engine", ["chees", "snaper"])
def test_chees_mesh_tuning_equals_one_process_run(ranks, engine):
    """dp = 4 runs the one-process run's 16 chains: after 8 warmup
    iterations with a mass window closing at the fifth, its step size,
    trajectory length, inverse mass (and SNAPER's principal component)
    equal that run's within f32 rounding of sums taken in another order
    (1e-4 relative). A reduction summed over the ranks where it should
    be averaged would miss by a factor near 4. (Whole runs are not
    compared: the rounding differences, 5e-7 in log eps at the seventh
    iteration, grow to 0.1 by the fifteenth on this model, and the L of
    the two runs then part.)"""
    results, _ = ranks
    model = compile_logp(gaussian8_ir(), device="cpu")
    _, carry, _ = run_groups(model, None, 1, 16, 8, 0, 2, engine, kernel=_window_kernel())
    want = _tuning(carry)
    for r in results:
        assert r[engine]["tuning"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(r[engine]["tuning"][k], v, rtol=1e-4, err_msg=k)


def test_init_redraws_keep_the_generator_in_step_over_ranks(ranks):
    """Only rank 2's inits are redrawn, yet every rank's chains and its
    rows of the next (16, d) draw equal the one-process run's."""
    results, _ = ranks
    gen = torch.Generator().manual_seed(3)
    q, _, _ = _find_valid_init(_half_space_vag, torch.as_tensor(INIT_Q), gen)
    noise = torch.randn(16, 2, generator=gen)
    assert (q[8:12, 0] < 1.0).all()
    for rank, r in enumerate(results):
        got_q, got_noise = r["init"]
        np.testing.assert_array_equal(got_q, q[4 * rank:4 * rank + 4].numpy())
        np.testing.assert_array_equal(got_noise, noise[4 * rank:4 * rank + 4].numpy())


@pytest.mark.parametrize("engine", ["chees", "snaper"])
def test_chees_mesh_of_one_rank_equals_no_mesh(engine):
    """A mesh of one rank runs the unsharded code bit for bit."""
    fn = sample_chees if engine == "chees" else sample_snaper
    kw = dict(num_chains=8, num_warmup=60, num_samples=30, seed=4)
    t1, s1 = fn(gaussian8_ir(), device="cpu", **kw)
    t2, s2 = fn(gaussian8_ir(), mesh=make_mesh(device="cpu"), **kw)
    np.testing.assert_array_equal(t1["x"], t2["x"])
    for k in s1:
        np.testing.assert_array_equal(np.asarray(s1[k]), np.asarray(s2[k]))


@pytest.mark.parametrize("pooled,model", [(False, "simple"), (True, "simple"),
                                          (False, "sv_marginal")],
                         ids=["False", "True", "sv_marginal"])
def test_one_rank_mesh_equals_unsharded_run(pooled, model):
    """``sample_chains_sharded`` on a mesh of one rank is the port's
    unsharded run of the same chains and seed, bit for bit, with the
    same counts: a Laplace marginal's counters (``stats["laplace"]``)
    stay the run's dict, out of the per-chain gather."""
    if model == "simple":
        ir, chains, opts = simple_ir(), 8, dict(num_warmup=40, num_samples=20)
    else:
        r = np.random.default_rng(4).normal(scale=0.02, size=60)
        ir, chains = sv_marginal_model(r, newton_iters=8), 2
        opts = dict(num_warmup=5, num_samples=5, ncp=False)
    opts["pooled_adaptation"] = pooled
    trace, stats = sample_chains_sharded(ir, chains, make_mesh(1, device="cpu"), seed=5,
                                         **opts)
    ref, ref_stats = exmc_tpu_torch.sample(ir, num_chains=chains, seed=5, device="cpu",
                                           **opts)
    for k in ref:
        np.testing.assert_array_equal(trace[k], ref[k])
    counts = HostSyncs.stat_keys(compile_logp(ir, device="cpu").counters)
    assert ("laplace" in counts) == (model == "sv_marginal")
    for k in ref_stats:
        if k in counts:
            assert stats[k] == ref_stats[k] and type(stats[k]) is type(ref_stats[k]), k
        else:
            np.testing.assert_array_equal(stats[k], ref_stats[k])
    assert stats["chain_ok"].all() and stats["redispatched"] == 0


def test_one_rank_data_parallel_vag_is_the_models():
    ir, data = _normal_obs_ir(exmc_tpu_torch)
    model = compile_logp(ir, device="cpu")
    vag, _ = data_parallel_vag(model, make_mesh(device="cpu"), data)
    q = torch.as_tensor(VAG_POINTS[:, None])
    for got, want in zip(vag(q), model.value_and_grad(q, model.device_data(data))):
        assert torch.equal(got, want)


def test_unknown_option_and_mesh_size_rejected():
    with pytest.raises(TypeError, match="unknown sampler options"):
        sample_chains_sharded(simple_ir(), 8, make_mesh(device="cpu"), nmu_warmup=10)
    with pytest.raises(ValueError, match="one device per rank"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="dp"):
        make_mesh(1, dp=2, device="cpu")


def test_parallel_all_is_the_jax_packages():
    import exmc_tpu.parallel

    import exmc_tpu_torch.parallel

    assert exmc_tpu_torch.parallel.__all__ == exmc_tpu.parallel.__all__


def test_entry_points_default_to_the_card():
    """``make_mesh`` (and so every sharded entry point) runs on "cuda"
    unless asked for the CPU; without a card it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh()


@pytest.mark.gpu
def test_parallel_checks_on_the_card():
    """The card's parallel checks at the small sizes: two gloo ranks
    sharing cuda:0, one NCCL rank, example 46's stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from exmc_tpu_torch.benchmarks import parallel

    assert parallel.main(["--small", "--timeout", "300"]) == 0
