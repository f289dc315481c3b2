"""The sampler's run modes and the runtime data channel in the port,
held against the JAX package on the CPU where it defines the result, and
against the port's own ``run`` where the result is the port's:

* ``CompiledModel.unconstrain`` equal to JAX's on NCP, GRW, det-scale
  and Stan affine models (1e-5), and a round trip of ``constrain``;
* ``value_and_grad(flat, data)`` equal to JAX's (2e-5 of max(1,
  |value|)) with whole and keyed data, and an interweave step reading
  the channel in lockstep with JAX's (1e-5);
* dict and array inits start there; the warm-start fine-tune's control
  arrays equal JAX's exactly; shared warmup gives every chain one step
  size and one metric;
* ``run_chunked``, a checkpoint resume and ``sample_stream`` bit for bit
  ``run``'s draws and stats; the sampler cache reusing one sampler for
  IRs that differ in data only, with a fresh sampler's results.
"""

import os
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu import compiler as jcompiler
from exmc_tpu import stan as jstan
from exmc_tpu.benchmarks import validation as jvalidation
from exmc_tpu.nuts import interweave as jiw
from exmc_tpu.nuts import sampler as jsampler
from exmc_tpu_torch import compiler as tcompiler
from exmc_tpu_torch import stan as tstan
from exmc_tpu_torch.benchmarks import entry
from exmc_tpu_torch.benchmarks import validation as tvalidation
from exmc_tpu_torch.nuts import interweave as tiw
from exmc_tpu_torch.nuts import sampler as tsampler

from test_torch_interweave import _jax_rand, _points, _t, grw_obs_model
from test_torch_stan import PROGRAMS, PROGRAM_IDS

J_GOLDS = {m.__name__: m for m in jvalidation._all_gold_standards()}
T_GOLDS = {m.__name__: m for m in tvalidation.all_gold_standards()}


def _program(name):
    _, code, data = PROGRAMS[PROGRAM_IDS.index(name)]
    return code, data


def _det_scale(pkg):
    """An NCP latent whose scale is a det node of a free RV."""
    B, d = pkg.Builder, pkg.dists
    ir = B.new_ir()
    ir = B.rv(ir, "v", d.Normal, {"mu": 0.0, "sigma": 1.5})
    ir = B.det(ir, "s", "exp", ["v"])
    ir = B.rv(ir, "m", d.Normal, {"mu": 1.0, "sigma": 2.0})
    ir = B.rv(ir, "x", d.Normal, {"mu": "m", "sigma": "s"}, shape=(4,))
    return B.obs(B.rv(ir, "y", d.Normal, {"mu": "x", "sigma": 1.0}, shape=(4,)),
                 "y_obs", "y", np.array([0.3, -1.2, 2.0, 0.7], np.float32))


def _ir_pair(case):
    """(JAX IR, port IR, ncp) of one unconstrain case."""
    if case in ("eight_schools_affine", "affine_constant", "eight_schools_ncp"):
        code, data = _program(case)
        return jstan.compile(code, data), tstan.compile(code, data), True
    if case in ("det_scale", "grw_obs"):
        build = _det_scale if case == "det_scale" else grw_obs_model
        return build(exmc_tpu), build(exmc_tpu_torch), True
    jg, tg = J_GOLDS[case](), T_GOLDS[case]()
    assert jg.ncp == tg.ncp
    return jg.ir, tg.ir, jg.ncp


UNCONSTRAIN_CASES = ["_eight_schools", "grw_obs", "stan_eight_schools",
                     "radon_varying_intercept", "eight_schools_affine",
                     "affine_constant", "det_scale"]


@pytest.mark.parametrize("case", UNCONSTRAIN_CASES)
def test_unconstrain_matches_jax(case):
    jir, tir, ncp = _ir_pair(case)
    jm = jcompiler.compile_logp(jir, ncp=ncp)
    tm = tcompiler.compile_logp(tir, ncp=ncp, device="cpu")
    assert sorted(tm.ncp_info) == sorted(jm.ncp_info)
    assert tm.ncp_info or case == "eight_schools_ncp"
    assert [i.get("kind") for i in tm.ncp_info.values()] == [
        i.get("kind") for i in jm.ncp_info.values()]
    x = np.random.default_rng(4).uniform(-1.5, 1.5, size=tm.size).astype(np.float32)
    xmap = {k: np.asarray(v) for k, v in
            jcompiler.constrain_flat(jm.ir, jm.pm, jnp.asarray(x)).items()}
    want = np.asarray(jm.unconstrain(xmap))
    got = tm.unconstrain(xmap).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and back: unconstrain inverts the port's own constrain
    np.testing.assert_allclose(got, x, rtol=1e-4, atol=1e-4)
    back = tm.constrain(torch.as_tensor(got)[None])
    for k, v in xmap.items():
        np.testing.assert_allclose(back[k][0].numpy(), v, rtol=1e-4, atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# the runtime data channel
# ---------------------------------------------------------------------------

def _whole(pkg, y):
    B, d = pkg.Builder, pkg.dists
    ir = B.new_ir()
    ir = B.rv(ir, "mu", d.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = B.rv(ir, "s", d.HalfNormal, {"sigma": 2.0})
    ir = B.rv(ir, "y", d.StudentT, {"df": 5.0, "loc": "mu", "scale": "s"}, shape=(len(y),))
    ir = B.obs(ir, "y_obs", "y", "__obs_data", reduce="sum")
    ir = B.det(ir, "ybar", "mean", ["__obs_data"])
    ir = B.rv(ir, "z", d.Normal, {"mu": "ybar", "sigma": 1.0})
    return B.data(ir, y)


def _keyed(pkg, data):
    """stress-like hierarchy: theta_g ~ N(mu, tau), y_g ~ N(theta_g, sigma)
    with every y_g read from the channel by key."""
    B, d = pkg.Builder, pkg.dists
    ir = B.new_ir()
    ir = B.rv(ir, "mu", d.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = B.rv(ir, "tau", d.HalfNormal, {"sigma": 2.0})
    ir = B.rv(ir, "sigma", d.HalfNormal, {"sigma": 1.0})
    for g in sorted(data):
        ir = B.rv(ir, f"theta_{g}", d.Normal, {"mu": "mu", "sigma": "tau"})
        ir = B.rv(ir, f"y_{g}", d.Normal, {"mu": f"theta_{g}", "sigma": "sigma"})
        ir = B.obs(ir, f"y_{g}_obs", f"y_{g}", ("__obs_data", g), reduce="sum")
    return B.data(ir, data)


def _data_sets(case, seed):
    rng = np.random.default_rng(seed)
    if case == "whole":
        return rng.normal(1.0, 2.0, size=30).astype(np.float32)
    return {str(g): rng.normal(g * 0.5, 0.8, size=12).astype(np.float32) for g in range(3)}


def _build(case, pkg, data):
    return _whole(pkg, data) if case == "whole" else _keyed(pkg, data)


@pytest.mark.parametrize("ncp", [False, True], ids=["centered", "ncp"])
@pytest.mark.parametrize("case", ["whole", "keyed"])
def test_value_and_grad_with_data_matches_jax(case, ncp):
    data_a, data_b = _data_sets(case, 0), _data_sets(case, 1)
    jm = jcompiler.compile_logp(_build(case, exmc_tpu, data_a), ncp=ncp)
    tm = tcompiler.compile_logp(_build(case, exmc_tpu_torch, data_a), ncp=ncp, device="cpu")
    x = np.random.default_rng(2).uniform(-1.5, 1.5, size=(4, tm.size)).astype(np.float32)
    for data in (data_a, data_b):
        jl, jg = jax.vmap(lambda f: jm.value_and_grad(f, data))(jnp.asarray(x))
        jl, jg = np.asarray(jl), np.asarray(jg)
        for arg in (data, tm.device_data(data)):
            tl, tg = tm.value_and_grad(torch.as_tensor(x), arg)
            err_lp = np.abs(tl.numpy() - jl) / np.maximum(1.0, np.abs(jl))
            err_g = np.abs(tg.numpy() - jg) / np.maximum(1.0, np.abs(jg).max(-1, keepdims=True))
            assert err_lp.max() <= 2e-5 and err_g.max() <= 2e-5
        np.testing.assert_allclose(tm.logp(torch.as_tensor(x), data).numpy(), jl,
                                   rtol=2e-5, atol=2e-5)
    own = tm.value_and_grad(torch.as_tensor(x))
    on_a = tm.value_and_grad(torch.as_tensor(x), data_a)
    on_b = tm.value_and_grad(torch.as_tensor(x), data_b)
    assert torch.equal(own[0], on_a[0]) and torch.equal(own[1], on_a[1])
    assert not torch.equal(own[0], on_b[0])
    # constrained values read the channel too ("z" hangs on mean(y))
    jc = jax.vmap(lambda f: jcompiler.constrain_flat(jm.ir, jm.pm, f, data_b))(jnp.asarray(x))
    tc = tm.constrain(torch.as_tensor(x), data_b)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-5, atol=1e-5)


def test_interweave_reads_the_data_channel():
    """One interweave step of the keyed hierarchy (an ancillary leg for
    tau, an obs-noise leg for sigma, both reading the channel) on data
    set B, with JAX's randomness injected, against JAX's step on B."""
    data_a, data_b = _data_sets("keyed", 0), _data_sets("keyed", 1)
    jm = jcompiler.compile_logp(_keyed(exmc_tpu, data_a), ncp=False)
    tm = tcompiler.compile_logp(_keyed(exmc_tpu_torch, data_a), ncp=False, device="cpu")
    groups = tiw.eligible_groups(tm)
    assert {g["sigma_id"] for g in groups} == {"tau", "sigma"}
    assert all(any(s[0] == "data" for s in entry._obs_specs(g)) for g in groups)
    c = 16
    q = _points(c, tm.size, 0)
    keys = jax.random.split(jax.random.PRNGKey(3), c)
    rand = _jax_rand(jiw.eligible_groups(jm), keys)
    step = tiw.build_interweave(tm)
    outs = {}
    for tag, data in (("a", data_a), ("b", data_b)):
        jq, jacc = jax.jit(jax.vmap(lambda qq, kk: jiw.build_interweave(jm)(qq, kk, data)))(
            jnp.asarray(q), keys)
        tq, tacc = step(_t(q), rand=rand, data=tm.device_data(data))
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-5)
        outs[tag] = tq
    own, _ = step(_t(q), rand=rand)
    assert torch.equal(own, outs["a"]) and not torch.equal(outs["a"], outs["b"])


# ---------------------------------------------------------------------------
# inits, warm start, shared warmup
# ---------------------------------------------------------------------------

def _es_sampler(**opts):
    code, data = _program("eight_schools_ncp")
    return tsampler._make_sampler(tstan.compile(code, data), ncp=False, device="cpu",
                                  **dict(dict(num_warmup=40, num_samples=30,
                                              max_tree_depth=6), **opts))


def test_dict_and_array_inits_start_there():
    code, data = _program("eight_schools_affine")
    jm = jcompiler.compile_logp(jstan.compile(code, data))
    smp = tsampler._make_sampler(tstan.compile(code, data), device="cpu",
                                 num_warmup=20, num_samples=10)
    init = {"mu": 1.5, "tau": 2.0, "theta": np.linspace(-3, 3, 8)}
    want = np.asarray(jsampler.NUTSSampler(model=jm)._resolve_inits(
        init, 6, jax.random.PRNGKey(0), jm.size, jnp.float32, None))
    got = smp._resolve_inits(init, 6, seed=0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    p = smp._start(6, 0, init, None, None)
    np.testing.assert_array_equal(p.carry.q.numpy(), got.numpy())
    arr = np.random.default_rng(0).normal(size=(6, smp.model.size)).astype(np.float32)
    p = smp._start(6, 0, arr, None, None)
    np.testing.assert_array_equal(p.carry.q.numpy(), arr)
    trace, _ = smp.run(num_chains=6, seed=0, init=init)
    assert trace["theta"].shape == (6, 10, 8) and np.isfinite(trace["theta"]).all()
    with pytest.raises(ValueError, match="shape"):
        smp.run(num_chains=5, init=arr)
    # init="pathfinder": the chains start from the best Pathfinder path's
    # draws, which are distinct per chain
    p = smp._start(6, 0, "pathfinder", None, None)
    assert p.carry.q.shape == (6, smp.model.size)
    assert torch.isfinite(p.carry.q).all() and len(set(p.carry.q[:, 0].tolist())) == 6
    trace, _ = smp.run(num_chains=6, seed=0, init="pathfinder")
    assert trace["theta"].shape == (6, 10, 8) and np.isfinite(trace["theta"]).all()
    with pytest.raises(ValueError, match="unknown init mode"):
        smp.run(num_chains=6, init="nope")


@pytest.mark.parametrize("max_depth,num_samples", [(10, 30), (6, 7)])
def test_fine_tune_xs_match_jax(max_depth, num_samples):
    jm = jcompiler.compile_logp(jstan.compile(*_program("basic")))
    js = jsampler.NUTSSampler(model=jm, max_tree_depth=max_depth, num_warmup=90)
    ts = tsampler._make_sampler(tstan.compile(*_program("basic")), device="cpu",
                                max_tree_depth=max_depth, num_warmup=90)
    assert ts._ft_schedule.num_warmup == tsampler.FINE_TUNE_ITERS == jsampler.FINE_TUNE_ITERS
    for sched, jsched, search in ((ts._ft_schedule, js._ft_schedule, False),
                                  (ts._schedule, js._schedule, True)):
        got = tsampler._pipeline_xs(sched, num_samples, max_depth, initial_search=search)
        want = jsampler._pipeline_xs(jsched, num_samples, max_depth, initial_search=search)
        # JAX's has the streaming emit flags before the draw index
        assert len(got) == 7 and len(want) == 8
        for g, w in zip(got, want[:6] + want[7:]):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


@pytest.mark.parametrize("dense", [False, True], ids=["diag", "dense"])
def test_warm_start_fine_tune(dense):
    smp = _es_sampler(dense_mass=dense)
    _, st = smp.run(num_chains=6, seed=1)
    warm = {"step_size": st["step_size"], "inv_mass": st["inv_mass"][0]}
    trace, st2 = smp.run(num_chains=6, seed=2, warm_start=warm)
    assert smp.last_run["iterations"] == tsampler.FINE_TUNE_ITERS + 30
    # the metric is not adapted: every chain keeps the warm start's
    np.testing.assert_array_equal(st2["inv_mass"],
                                  np.broadcast_to(warm["inv_mass"], st2["inv_mass"].shape))
    assert st2["inv_mass"].shape == st["inv_mass"].shape
    assert np.isfinite(trace["mu"]).all() and (st2["step_size"] > 0).all()


def test_shared_warmup_one_step_size_and_metric():
    res = entry.check_shared_warmup("cpu", chains=6, warmup=40, samples=30, gates=False)
    assert res["ok"] and res["one_step_size"] and res["one_metric"], res
    with pytest.raises(ValueError, match="mutually exclusive"):
        _es_sampler(shared_warmup=True, pooled_adaptation=True)
    smp = _es_sampler(shared_warmup=True)
    # the JAX package's run_chunked runs the per-chain pipeline whatever
    # the option; the port refuses it
    with pytest.raises(ValueError, match="shared_warmup"):
        smp.run_chunked(num_chains=6)
    trace, stats = smp.run(num_chains=6, seed=3)
    assert smp.last_run["iterations"] == 40 + 30
    assert (stats["recoveries"] == 0).all() and np.isfinite(trace["mu"]).all()
    # the sampling randomness is seeded apart from the warmup's: chain 0
    # does not replay its warmup's draws
    assert trace["mu"].shape == (6, 30) and len(np.unique(trace["mu"][:, 0])) == 6


# ---------------------------------------------------------------------------
# chunked, resumed, streamed
# ---------------------------------------------------------------------------

CHUNK_CASES = {
    "diag_uneven": (dict(), 17),
    "diag_one_chunk": (dict(), 1000),
    "dense_pooled": (dict(dense_mass=True, pooled_adaptation=True), 23),
    "interweave": (dict(interweave=True, gibbs_scales=True), 29),
    "warm_start": (dict(), 13),
}


def _chunk_sampler(case):
    opts, _ = CHUNK_CASES[case]
    if case == "interweave":
        return tsampler._make_sampler(_keyed(exmc_tpu_torch, _data_sets("keyed", 0)),
                                      ncp=False, device="cpu", num_warmup=40,
                                      num_samples=30, **opts)
    return _es_sampler(**opts)


def _same_run(x, y):
    return entry._same_run(x, y)


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunked_equals_run(case):
    smp = _chunk_sampler(case)
    kw = {}
    if case == "warm_start":
        _, st = smp.run(num_chains=6, seed=4)
        kw["warm_start"] = {"step_size": st["step_size"], "inv_mass": st["inv_mass"]}
    base = smp.run(num_chains=6, seed=5, **kw)
    syncs = smp.last_run["host_syncs"]
    got = smp.run_chunked(num_chains=6, seed=5, chunk_iters=CHUNK_CASES[case][1], **kw)
    assert _same_run(base, got)
    assert smp.last_run["host_syncs"] == syncs


@pytest.mark.parametrize("case", ["diag_uneven", "interweave", "warm_start"])
def test_resume_equals_uninterrupted(case, tmp_path):
    """A run killed after a chunk continues from its checkpoint to the
    uninterrupted run's draws and stats, bit for bit."""
    smp = _chunk_sampler(case)
    kw = {}
    if case == "warm_start":
        _, st = smp.run(num_chains=6, seed=4)
        kw["warm_start"] = {"step_size": st["step_size"], "inv_mass": st["inv_mass"]}
    chunk = CHUNK_CASES[case][1]
    base = smp.run(num_chains=6, seed=6, **kw)
    ckpt, saved = str(tmp_path / "ckpt.npz"), []

    def keep(start, trace, stats):
        path = str(tmp_path / f"after_{len(saved)}.npz")
        shutil.copy(ckpt, path)
        saved.append(path)

    full = smp.run_chunked(num_chains=6, seed=6, chunk_iters=chunk, checkpoint_path=ckpt,
                           callback=keep, **kw)
    assert _same_run(base, full) and len(saved) >= 2
    for path in (saved[0], saved[-1], ckpt):
        resumed = smp.run_chunked(num_chains=6, seed=6, chunk_iters=chunk,
                                  resume_from=path, **kw)
        assert _same_run(base, resumed), path
    assert os.path.exists(ckpt)


def test_sample_stream_callbacks_total_the_trace():
    chunked, stream = entry.check_chunked_and_stream(
        "cpu", chains=4, warmup=30, samples=20, chunk=11, every=4, gates=False)
    # chunks of 11 over 30 + 20 iterations: the first draws come in the
    # third chunk, so the resume starts after the second
    assert chunked["ok"] and chunked["resumed_from_iteration"] == 22, chunked
    assert stream["ok"], stream
    assert stream["every_callbacks"] == 5 and stream["every_extra_syncs"] == 5
    assert stream["chunked_callbacks"] == 3  # chunks ending at 33, 44, 50
    with pytest.raises(ValueError, match="every"):
        tsampler.sample_stream(tstan.compile(*_program("basic")), print, every=0,
                               device="cpu")


# ---------------------------------------------------------------------------
# the sampler cache
# ---------------------------------------------------------------------------

def test_sampler_cache_reuses_one_sampler_across_data():
    tsampler.clear_sampler_cache()
    y_a, y_b = _data_sets("whole", 0), _data_sets("whole", 1)
    ir_a, ir_b = _whole(exmc_tpu_torch, y_a), _whole(exmc_tpu_torch, y_b)
    opts = dict(device="cpu", num_warmup=30, num_samples=20)
    s_a = tsampler._make_sampler(ir_a, **opts)
    assert tsampler._make_sampler(ir_b, **opts) is s_a
    assert tsampler.ir_signature(ir_a) == tsampler.ir_signature(ir_b)
    tr_b, st_b = tsampler.sample(ir_b, num_chains=4, seed=7, **opts)
    tr_a, _ = tsampler.sample(ir_a, num_chains=4, seed=7, **opts)
    fresh = tsampler.NUTSSampler(model=tcompiler.compile_logp(ir_b, device="cpu"),
                                 num_warmup=30, num_samples=20)
    assert _same_run((tr_b, st_b), fresh.run(num_chains=4, seed=7))
    assert not np.array_equal(tr_a["mu"], tr_b["mu"])
    assert len(tsampler._SAMPLER_CACHE) == 1
    # options, ncp and devices key apart; inline values by value
    assert tsampler._make_sampler(ir_a, **dict(opts, num_samples=21)) is not s_a
    assert tsampler._make_sampler(ir_a, ncp=False, **opts) is not s_a
    inline = [exmc_tpu_torch.stan.compile(*_program("basic"))]
    inline.append(exmc_tpu_torch.stan.compile(_program("basic")[0], {"y": 4.0}))
    assert tsampler.ir_signature(inline[0]) != tsampler.ir_signature(inline[1])
    for i in range(tsampler._SAMPLER_CACHE_MAX + 2):
        tsampler._make_sampler(ir_a, device="cpu", num_warmup=i)
    assert len(tsampler._SAMPLER_CACHE) == tsampler._SAMPLER_CACHE_MAX
    tsampler.clear_sampler_cache()


def test_ir_fingerprint_stability_matches_jax():
    """Torch callables hash by identity: their signatures are unstable,
    as the JAX package marks per-process objects; plain IRs are stable."""
    ir = _whole(exmc_tpu_torch, _data_sets("whole", 0))
    assert tsampler.ir_fingerprint(ir)[1] is True
    cust = exmc_tpu_torch.dists.Custom(logpdf_fn=lambda x, p: -0.5 * x * x)
    ir2 = exmc_tpu_torch.Builder.rv(ir, "c", cust, {})
    assert tsampler.ir_fingerprint(ir2)[1] is False
    stan_ir = tstan.compile(*_program("target_lpdf_vector"))
    assert tsampler.ir_fingerprint(stan_ir)[1] is False
    assert jsampler.ir_fingerprint(_whole(exmc_tpu, _data_sets("whole", 0)))[1] is True


def test_sample_chains_and_exports():
    ir = _whole(exmc_tpu_torch, _data_sets("whole", 0))
    trace, stats = exmc_tpu_torch.sample_chains(ir, device="cpu", num_warmup=20,
                                                num_samples=10)
    assert trace["mu"].shape == (4, 10) and stats["step_size"].shape == (4,)
    for name in ("stan", "Model", "sample_chains", "sample_stream"):
        assert name in exmc_tpu_torch.__all__ and name in exmc_tpu.__all__
    for name in ("fit_map", "laplace", "psir", "advi_fit", "pathfinder_fit",
                 "sample_chees", "sample_snaper", "sample_meads"):
        assert name in exmc_tpu_torch.__all__ and name in exmc_tpu.__all__
    trace, stats = exmc_tpu_torch.sample(ir, device="cpu", engine="chees",
                                         num_chains=8, num_warmup=20, num_samples=10)
    assert trace["mu"].shape == (8, 10) and np.isfinite(trace["mu"]).all()
    assert stats["step_size"].shape == () and stats["host_syncs"] >= 30


def test_data_warm_start_check_on_cpu():
    """The entry phase's data check at a small size: the refit through
    the cached sampler, bit for bit a fresh compile on B; the channel-fed
    stress model has its Gibbs legs on the channel."""
    res = entry.check_data_warm_start("cpu", chains=8, warmup=60, samples=60, n_obs=2000,
                                      stress_chains=8, gates=False)
    assert res["ok"], res
    assert res["same_cached_sampler"] and res["refit_vag_bit_equal"]
    assert res["refit_bit_equal_fresh"]
    assert res["refit_b_iterations"] == tsampler.FINE_TUNE_ITERS + 60
    assert res["stress_channel_groups"] == 2


@pytest.mark.gpu
def test_graphed_value_and_grad_reads_new_data_on_card():
    """On the card: the CUDA graph of a model compiled on A, replayed on
    B's data buffers, gives bit for bit a fresh compile on B."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = entry.check_data_warm_start("cuda", chains=64, warmup=60, samples=60,
                                      n_obs=10_000, stress_chains=64, gates=False)
    assert res["ok"] and res["refit_vag_bit_equal"] and res["refit_bit_equal_fresh"], res
