"""ChEES, SNAPER and MEADS in the port against the JAX package on the CPU,
and the ``engine=`` dispatch of ``sample``.

The lockstep tests run each iteration of the port from the JAX
kernel's carry before it (recorded from its scans and carried over by
``interop.ensemble_state_from_numpy``), with the JAX key discipline's
draws (per chain and iteration i: the momentum or refresh normals from
fold_in(fold_in(key, i), 1), the accept uniform from
fold_in(fold_in(key, i), 2)), and hold the result against JAX's carry
after it, at every warmup and sampling iteration: ChEES/SNAPER's L, step
size, logT (and logT_bar, the metric, SNAPER's principal component) and
q; MEADS's q, momentum and logp, fold by fold, and each fold's step size
and damping. A whole ChEES run from JAX's initial carry keeps JAX's L at
every iteration.

Tolerances: 1e-4 relative / 1e-5 absolute in f32 (the same arithmetic;
the model's log-density sums in another order); L exactly, which also
shows that no float tie in ceil(u T / eps) moves it at these sizes.
"""

from functools import partial

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu import chees as jchees
from exmc_tpu import meads as jmeads
from exmc_tpu.compiler import compile_logp as jcompile
from exmc_tpu_torch import chees as tchees
from exmc_tpu_torch import meads as tmeads
from exmc_tpu_torch.compiler import compile_logp as tcompile
from exmc_tpu_torch.interop import ensemble_state_from_numpy
from exmc_tpu_torch.nuts.masked import HostSyncs

from test_torch_vi import quickstart

RTOL, ATOL = 1e-4, 1e-5


def _close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


def eight_schools(pkg):
    B, D = pkg.Builder, pkg.dists
    y = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
    sd = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]
    ir = B.new_ir()
    ir = B.rv(ir, "mu", D.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = B.rv(ir, "tau", D.HalfCauchy, {"scale": 5.0})
    for i in range(8):
        ir = B.rv(ir, f"theta_{i}", D.Normal, {"mu": "mu", "sigma": "tau"})
        ir = B.rv(ir, f"y_{i}", D.Normal, {"mu": f"theta_{i}", "sigma": sd[i]})
        ir = B.obs(ir, f"y_{i}_obs", f"y_{i}", y[i])
    return ir


MODELS = {"eight_schools": eight_schools, "quickstart": quickstart}


def record_jax_run(run, *args):
    """Run a JAX engine kernel with each scan's initial carry and every
    step's new carry and output sent to the host: (starts, steps)."""
    starts, steps = [], []
    scan = jax.lax.scan

    def spy(f, init, xs, length=None, **k):
        tag = f.__name__
        jax.debug.callback(lambda c: starts.append((tag, c)), init, ordered=True)

        def g(c, x):
            nc, y = f(c, x)
            jax.debug.callback(lambda c2, yy: steps.append((tag, c2, yy)), nc, y,
                               ordered=True)
            return nc, y

        return scan(g, init, xs, length=length, **k)

    jax.lax.scan = spy
    try:
        out = jax.jit(run)(*args)
        jax.block_until_ready(out)
    finally:
        jax.lax.scan = scan
    return starts, steps


@partial(jax.jit, static_argnums=2)
def _jax_draws(keys, i, d):
    ki = jax.vmap(lambda k: jax.random.fold_in(k, i))(keys)
    z = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 1), (d,),
                                             jnp.float32))(ki)
    un = jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, 2)))(ki)
    return z, un


def jax_draws(keys, i, d):
    """Iteration i's (normals (C, d), uniforms (C,)) from per-chain keys."""
    z, un = _jax_draws(keys, i, d)
    return torch.as_tensor(np.array(z)), torch.as_tensor(np.array(un))


def _vag(model):
    return lambda q: model.value_and_grad(q)


CHEES_CASES = [("eight_schools", "chees", 16, 8, 6), ("eight_schools", "snaper", 16, 8, 6),
               ("quickstart", "chees", 8, 45, 5)]


def _carries(starts, steps):
    """JAX's carry before each iteration, and after it with its output."""
    before = [starts[0][1]] + [st[1] for st in steps[:-1]]
    return [(jax.tree_util.tree_map(np.asarray, b), tag,
             jax.tree_util.tree_map(np.asarray, a), y)
            for b, (tag, a, y) in zip(before, steps)]


@pytest.mark.parametrize("model,criterion,chains,warmup,samples", CHEES_CASES)
def test_chees_lockstep(model, criterion, chains, warmup, samples):
    """Each iteration from JAX's carry before it (carried over by
    ``interop``) against JAX's carry after it; then the whole run from
    JAX's initial carry, whose L equals JAX's over the first 14
    iterations (its positions drift from JAX's by f32 rounding that
    L-step trajectories amplify, ~1e-3 after 14 iterations, and the
    drift reaches T / eps, hence L, later: 8 against 10 at iteration 36
    of the quickstart case; so only early L is held there). 45
    warmup iterations reach the schedule's one window end (the pooled
    Welford metric) on the quickstart model."""
    jm = jcompile(MODELS[model](exmc_tpu))
    tm = tcompile(MODELS[model](exmc_tpu_torch), device="cpu")
    d = tm.size
    run = jchees._build_kernel(jm, chains, warmup, samples, 0.651, 1024,
                               criterion=criterion)
    base = jax.random.PRNGKey(3)
    init_keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.fold_in(base, 10_000_019), jnp.arange(chains))
    starts, steps = record_jax_run(run, None, init_keys, jm.data,
                                   jax.random.fold_in(base, 424_243))
    assert [s[0] for s in starts] == ["warm_step", "samp_step"]
    assert len(steps) == warmup + samples
    keys = jnp.asarray(starts[0][1]["keys"])
    kernel = tchees._Kernel(warmup, samples)
    assert kernel.window_end.any() == (warmup == 45)
    halton = jchees._halton_base2(warmup + samples).astype(np.float32)

    def rand(i):
        return jax_draws(keys, i, d)

    want_l = []
    for i, (jb, tag, ja, jy) in enumerate(_carries(starts, steps)):
        if tag == "warm_step":
            eps, T = np.exp(jb["da"].log_eps), np.exp(jb["logT"])
            want_l.append(int(np.clip(np.asarray(jnp.ceil(
                jnp.float32(halton[i]) * jnp.float32(T) / jnp.float32(eps))), 1, 1024)))
        else:
            want_l.append(int(np.asarray(jy["num_steps"])))
        seen = []
        tchees._run(_vag(tm), ensemble_state_from_numpy(jb, device="cpu"), kernel,
                    0.651, 1024, criterion, rand, HostSyncs(),
                    on_iter=lambda i, c, n: seen.append((c, n)), first=i, last=i + 1)
        (tc, n_steps), = seen
        assert n_steps.tolist() == [want_l[i]], f"L at iteration {i}"
        _close(tc["q"], ja["q"], msg=f"q at {i}")
        _close(tc["logp"], ja["logp"], atol=2e-5, msg=f"logp at {i}")
        # the port's tuning state has a leading axis of one group
        _close(tc["logT"][0], ja["logT"], msg=f"logT at {i}")
        _close(tc["logT_bar"][0], ja["logT_bar"], msg=f"logT_bar at {i}")
        _close(torch.exp(tc["da"].log_eps[0]), np.exp(ja["da"].log_eps),
               msg=f"step size at {i}")
        _close(tc["inv"][0], ja["inv"], msg=f"inv mass at {i}")
        if criterion == "snaper":
            _close(tc["pc"][0], ja["pc"], msg=f"pc at {i}")

    free = []
    tchees._run(_vag(tm), ensemble_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, starts[0][1]), device="cpu"), kernel,
        0.651, 1024, criterion, rand, HostSyncs(),
        on_iter=lambda i, c, n: free.append(int(n[0])))
    assert free[:14] == want_l[:14]


@pytest.mark.parametrize("model,chains,folds", [("eight_schools", 16, 4),
                                                ("quickstart", 6, 3)])
def test_meads_lockstep(model, chains, folds):
    """Each iteration, fold by fold, from JAX's carry before it: every
    fold's positions, momentum and logp, and (sampling iterations) each
    fold's step size and damping against JAX's."""
    warmup, samples = 6, 6
    jm = jcompile(MODELS[model](exmc_tpu))
    tm = tcompile(MODELS[model](exmc_tpu_torch), device="cpu")
    d = tm.size
    run = jmeads._build_kernel(jm, chains, folds, warmup, samples, 1.0, None)
    base = jax.random.PRNGKey(5)
    init_keys = jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.fold_in(base, 10_000_019), jnp.arange(chains))
    q_inits = 0.5 * jax.random.normal(jax.random.PRNGKey(9), (chains, d))
    starts, steps = record_jax_run(run, q_inits, init_keys, jm.data,
                                   jax.random.fold_in(base, 77_377))
    assert len(steps) == warmup + samples
    keys = jnp.asarray(starts[0][1]["keys"])
    kernel = tmeads._Kernel(warmup, samples)
    per = chains // folds
    for i, (jb, tag, ja, jy) in enumerate(_carries(starts, steps)):
        carry = ensemble_state_from_numpy(jb, device="cpu")
        assert sorted(carry) == ["grad", "logp", "q", "u"]
        tc, _, eps, gam = tmeads._run(_vag(tm), carry, kernel, folds, 1.0, None,
                                      lambda i: jax_draws(keys, i, d),
                                      first=i, last=i + 1)
        for k in range(folds):
            rows = slice(k * per, (k + 1) * per)
            for name in ("q", "u"):
                _close(tc[name][rows], ja[name][rows], msg=f"{name} of fold {k} at {i}")
            _close(tc["logp"][rows], ja["logp"][rows], atol=2e-5,
                   msg=f"logp of fold {k} at {i}")
        if tag == "samp_step":
            _, jeps, jgam = jy
            _close(eps[0], np.asarray(jeps), msg=f"fold step sizes at {i}")
            _close(gam[0], np.asarray(jgam), msg=f"fold dampings at {i}")


def test_fold_tuning_and_gram_match_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(16, 5)).astype(np.float32) * np.array([1, 2, 3, 0.5, 9], np.float32)
    g = rng.normal(size=(16, 5)).astype(np.float32) * 3e9  # the overflow guard's regime
    want = jmeads._fold_tuning(jnp.asarray(q), jnp.asarray(g), jnp.float32)
    got = tmeads._fold_tuning(torch.as_tensor(q), torch.as_tensor(g))
    for a, b in zip(got, want):
        _close(a, np.asarray(b))
    _close(tmeads._gram_lambda_max(torch.as_tensor(g)),
           np.asarray(jmeads._gram_lambda_max(jnp.asarray(g))), rtol=1e-4)


def test_chees_helpers_match_jax():
    rng = np.random.default_rng(6)
    q0, q1, v1 = (rng.normal(size=(12, 4)).astype(np.float32) for _ in range(3))
    q1[3, 1] = np.inf  # a diverged endpoint is masked out
    acc = rng.uniform(size=12).astype(np.float32)
    acc[5] = np.nan
    pc = np.array([0.5, 0.5, 0.5, 0.5], np.float32)
    inv = rng.uniform(0.5, 2.0, size=4).astype(np.float32)
    en = rng.uniform(size=12) > 0.3
    t = [torch.as_tensor(a) for a in (q0, q1, v1, acc, pc, inv)]
    j = [jnp.asarray(a) for a in (q0, q1, v1, acc, pc, inv)]
    _close(tchees._chees_grad(*t[:4], 0.7), np.asarray(jchees._chees_grad(*j[:4], 0.7)))
    _close(tchees._snaper_grad(*t[:4], 0.7, t[4], t[5]),
           np.asarray(jchees._snaper_grad(*j[:4], 0.7, j[4], j[5])))
    _close(tchees._harmonic_accept(t[3]), np.asarray(jchees._harmonic_accept(j[3])))
    _close(tchees._oja_update(t[4], t[0], t[5], torch.as_tensor(en), torch.tensor(7.0)),
           np.asarray(jchees._oja_update(j[4], j[0], j[5], jnp.asarray(en), 7.0)))
    np.testing.assert_array_equal(tchees._halton_base2(37), jchees._halton_base2(37))


@pytest.mark.parametrize("engine,want_chains", [("chees", 64), ("snaper", 64),
                                                ("meads", 128)])
def test_sample_engine_dispatch(engine, want_chains):
    """``sample(engine=...)`` runs the engine with its default chain count
    when num_chains is left at 1; the draws are finite and near the
    quickstart posterior."""
    trace, stats = exmc_tpu_torch.sample(quickstart(exmc_tpu_torch), engine=engine,
                                         device="cpu", num_warmup=60, num_samples=40,
                                         seed=1)
    assert trace["mu"].shape == (want_chains, 40)
    assert stats["accept_prob"].shape == (want_chains, 40)
    assert np.isfinite(trace["mu"]).all() and np.isfinite(trace["sigma"]).all()
    assert abs(float(trace["mu"].mean()) - 2.15) < 0.3
    if engine == "meads":
        assert stats["step_size"].shape == (4,) and stats["host_syncs"] <= 2
    else:
        # one host sync per iteration for L, plus the init search's
        assert 100 <= stats["host_syncs"] <= 100 + 40
        assert stats["num_steps_mean"] >= 1
    if engine == "snaper":
        assert stats["principal_component"].shape == (2,)


def test_engine_dispatch_refusals():
    ir = quickstart(exmc_tpu_torch)
    arr = np.zeros((64, 2), np.float32)
    with pytest.raises(ValueError, match="only dict inits"):
        exmc_tpu_torch.sample(ir, engine="chees", init=arr, device="cpu")
    with pytest.raises(ValueError, match="no warm_start"):
        exmc_tpu_torch.sample(ir, engine="snaper", warm_start={}, device="cpu")
    with pytest.raises(ValueError, match="no warm_start"):
        exmc_tpu_torch.sample(ir, engine="meads", warm_start={}, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        exmc_tpu_torch.sample(ir, engine="gibbs", device="cpu")
    class ThreeRanks:  # mesh= now runs; 64 chains do not split over 3 ranks
        shape = {"dp": 3, "sp": 1}

    with pytest.raises(ValueError, match="not divisible by dp=3"):
        tchees.sample_chees(ir, mesh=ThreeRanks(), device="cpu")
    with pytest.raises(ValueError, match="criterion='chees'"):
        tchees.sample_snaper(ir, criterion="chees", device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tmeads.sample_meads(ir, num_chains=10, device="cpu")
    with pytest.raises(ValueError, match="unknown init"):
        tmeads.sample_meads(ir, init="prior", device="cpu")


def test_meads_inits_and_the_fit_fallback(monkeypatch, recwarn):
    """A dict init starts every chain there (0.01 jitter); a failing
    Pathfinder fit falls back to overdispersed draws with a warning, and
    a device fault propagates."""
    ir = quickstart(exmc_tpu_torch)
    kw = dict(num_chains=8, num_folds=2, num_warmup=0, num_samples=2, device="cpu",
              return_unconstrained=True)
    draws, _ = tmeads.sample_meads(ir, init="random", **kw)
    assert draws.shape == (8, 2, 2) and np.isfinite(draws).all()

    from exmc_tpu_torch import pathfinder

    def broken(*a, **k):
        raise ValueError("no path")

    monkeypatch.setattr(pathfinder, "pathfinder_fit", broken)
    tmeads.sample_meads(ir, seed=3, **kw)
    assert any("fit failed" in str(w.message) for w in recwarn.list)

    def device_fault(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(pathfinder, "pathfinder_fit", device_fault)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tmeads.sample_meads(ir, seed=4, **kw)


def test_kernel_cache_reuses_the_compiled_model():
    tchees.clear_kernel_cache()
    ir = quickstart(exmc_tpu_torch)
    kw = dict(num_chains=4, num_warmup=3, num_samples=2, device="cpu")
    tchees.sample_chees(ir, **kw)
    (key, (model, _)), = tchees._KERNEL_CACHE._cache.items()
    tchees.sample_chees(quickstart(exmc_tpu_torch), seed=1, **kw)
    assert len(tchees._KERNEL_CACHE._cache) == 1
    assert tchees._KERNEL_CACHE._cache[key][0] is model
    assert key[-2:] == ("torch.float32", "cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    for fn in (tchees.sample_chees, tchees.sample_snaper, tmeads.sample_meads):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(quickstart(exmc_tpu_torch))


@pytest.mark.gpu
def test_engines_briefly_on_the_card():
    """ChEES, SNAPER and MEADS on eight schools at 256 chains on the card:
    finite draws near the posterior, L read once per iteration, and MEADS
    with no sync per iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ir = eight_schools(exmc_tpu_torch)
    for engine in ("chees", "snaper", "meads"):
        trace, stats = exmc_tpu_torch.sample(ir, engine=engine, num_chains=256,
                                             num_warmup=200, num_samples=100, seed=1)
        assert np.isfinite(trace["mu"]).all()
        assert abs(float(trace["mu"].mean()) - 4.4) < 1.0
        if engine == "meads":
            assert stats["host_syncs"] <= 2
        else:
            assert stats["host_syncs"] >= 300
