"""The port's ASIS interweave and NUTS-within-Gibbs against the JAX
package: eligibility, a lockstep of one interweave step with JAX's
randomness injected (every group kind), the conditional metric, the
frozen coordinate through a whole transition, the sampler's option
checks and energy bookkeeping, and a short prior-exactness run."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu import compiler as jcompiler
from exmc_tpu.benchmarks import suite as jsuite
from exmc_tpu.nuts import interweave as jiw
from exmc_tpu.nuts import leapfrog as jlf
from exmc_tpu.nuts import sampler as jsampler
from exmc_tpu.nuts import step_size as jss
from exmc_tpu.nuts import tree as jtree
from exmc_tpu_torch import compiler as tcompiler
from exmc_tpu_torch.benchmarks import suite as tsuite
from exmc_tpu_torch.nuts import interweave as tiw
from exmc_tpu_torch.nuts import leapfrog as tlf
from exmc_tpu_torch.nuts import sampler as tsampler
from exmc_tpu_torch.nuts import step_size as tss
from exmc_tpu_torch.nuts import tree as ttree

from test_torch_nuts import _jax_randomness_fn


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def grw_obs_model(pkg, t=40, seed=3):
    """tests/test_interweave.py:13 for either package."""
    B, d = pkg.Builder, pkg.dists
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.normal(0, 0.3, t))
    y = (x + rng.normal(0, 0.5, t)).astype(np.float32)
    ir = B.new_ir()
    ir = B.rv(ir, "sigma", d.HalfNormal, {"sigma": 1.0})
    ir = B.rv(ir, "x", d.GaussianRandomWalk, {"sigma": "sigma"}, shape=(t,))
    ir = B.rv(ir, "y", d.Normal, {"mu": "x", "sigma": 0.5}, shape=(t,))
    return B.obs(ir, "y_obs", "y", y)


def _suite(name, **kw):
    return lambda pkg: (jsuite if pkg is exmc_tpu else tsuite).MODELS[name](**kw)


# name -> (model builder taking the package, ncp); one case per group
# kind: ncp (sv, grw_obs, spectral sv), centered GRW, centered Normal
# with the regression ancillary leg, obs-noise, exp-chain prior mode
CASES = {
    "sv20_ncp": (_suite("sv", t=20), True),
    "sv20_centered": (_suite("sv", t=20), False),
    "sv100_ncp": (_suite("sv"), True),
    "eight_schools": (_suite("eight_schools"), False),
    "medium": (_suite("medium"), False),
    "stress": (_suite("stress"), False),
    "funnel": (_suite("funnel"), False),
    "grw_obs_ncp": (grw_obs_model, True),
    "grw_obs_centered": (grw_obs_model, False),
}


def _compiled(case):
    build, ncp = CASES[case]
    jm = jcompiler.compile_logp(build(exmc_tpu), ncp=ncp)
    tm = tcompiler.compile_logp(build(exmc_tpu_torch), ncp=ncp, device="cpu")
    return jm, tm


def _plain(x):
    """Group specs as comparable plain values: arrays as lists,
    transforms and dists by name, the exp-chain wrappers by (base, c)."""
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return ("array", x.shape, x.tolist())
    if hasattr(x, "c"):
        return ("exp_chain", _plain(getattr(x, "base", None)), x.c)
    if hasattr(x, "name"):
        return x.name
    return x


def _group_summary(g):
    return {k: _plain(g[k]) for k in ("sigma_id", "offset", "transform",
                                      "dist", "params", "zs", "n", "anc",
                                      "anc_mode")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eligible_groups_match_jax(case):
    jm, tm = _compiled(case)
    jg = [_group_summary(g) for g in jiw.eligible_groups(jm)]
    tg = [_group_summary(g) for g in tiw.eligible_groups(tm)]
    assert jg and tg == jg


def _jax_rand(groups, keys):
    """The draws of JAX's step for each chain key, split as the step
    splits them (interweave.py:638, :734)."""

    def one(key):
        out = []
        for g in groups:
            key, kchi, kacc = jax.random.split(key, 3)
            d = {"chi2": 2.0 * jax.random.gamma(kchi, 0.5 * g["n"],
                                                dtype=jnp.float32),
                 "u_acc": jax.random.uniform(kacc, dtype=jnp.float32)}
            if g["anc"] is not None:
                key, kanc, kacc2 = jax.random.split(key, 3)
                if g["anc_mode"] == "prior":
                    d["u_anc"] = g["dist"].sample(kanc, g["params"]).astype(
                        jnp.float32).reshape(())
                else:
                    d["u_anc"] = jax.random.uniform(kanc, dtype=jnp.float32)
                d["u_acc2"] = jax.random.uniform(kacc2, dtype=jnp.float32)
            out.append(d)
        return out

    out = jax.vmap(one)(keys)
    return [{k: _t(v) for k, v in d.items()} for d in out]


def _points(c, d, seed):
    """Uniform(-1, 1) points: the legs both accept and reject there."""
    return np.random.default_rng(seed).uniform(-1, 1, size=(c, d)).astype(
        np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_interweave_step_lockstep(case):
    """One step of the port on 16 chains against JAX's step vmapped over
    16 keys, with the chi^2 and uniform draws taken from those keys:
    the same accept fraction per chain and q' within 1e-5.

    The scale of a group with an ancillary leg is held in its
    constrained value: its draw m + s * ndtri(u) has an f32 absolute
    error of O(ulp(m)), which a log-like transform turns into a relative
    one on the unconstrained coordinate when the draw lands near 0."""
    jm, tm = _compiled(case)
    c = 16
    q = _points(c, tm.size, 0)
    keys = jax.random.split(jax.random.PRNGKey(1), c)
    jq, jacc = jax.jit(jax.vmap(jiw.build_interweave(jm)))(jnp.asarray(q), keys)
    rand = _jax_rand(jiw.eligible_groups(jm), keys)
    tq, tacc = tiw.build_interweave(tm)(_t(q), rand=rand)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    assert float(tacc.mean()) > 0.0
    jq = _t(jq)
    free = torch.ones(tm.size, dtype=torch.bool)
    for g in tiw.eligible_groups(tm):
        if g["anc"] is not None:
            off, tf = g["offset"], g["transform"]
            free[off] = False
            np.testing.assert_allclose(tf.forward(tq[:, off]).numpy(),
                                       tf.forward(jq[:, off]).numpy(),
                                       rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tq[:, free].numpy(), jq[:, free].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_ancillary_draw_at_clip_edges():
    """The truncated-normal inverse CDF at both clip edges of uu and at
    a far-negative mean: ndtri as JAX's, ndtr with its tail precision."""
    u = np.array([1e-7, 1.0 - 1e-7, 0.5, 0.3], np.float32)
    np.testing.assert_allclose(
        torch.special.ndtri(_t(u)).numpy(),
        np.asarray(jax.scipy.special.ndtri(jnp.asarray(u))), rtol=2e-7)
    x = np.array([-30.0, -12.0, -5.0, -0.6, 0.0, 0.6, 5.0, 12.0], np.float32)
    np.testing.assert_allclose(
        exmc_tpu_torch.math.ndtr(_t(x)).numpy(),
        np.asarray(jax.scipy.special.ndtr(jnp.asarray(x))), rtol=2e-6, atol=0)


def _frozen(groups):
    return {g["offset"] for g in groups
            if g["anc_mode"] is not None
            or {z[2] for z in g["zs"]} == {"obs_noise"}}


@pytest.mark.parametrize("case", ["eight_schools", "medium", "stress", "funnel"])
def test_conditional_metric_matches_jax(case):
    jm, tm = _compiled(case)
    frozen = _frozen(jiw.eligible_groups(jm))
    assert frozen == _frozen(tiw.eligible_groups(tm))
    jfn = jiw.build_conditional_metric(jm, frozen_offsets=frozen)
    tfn = tiw.build_conditional_metric(tm, frozen_offsets=frozen)
    rng = np.random.default_rng(2)
    q = rng.uniform(-2, 2, size=(8, tm.size)).astype(np.float32)
    inv = rng.uniform(0.5, 2.0, size=(8, tm.size)).astype(np.float32)
    ref = jax.vmap(jfn)(jnp.asarray(q), jnp.asarray(inv))
    got = tfn(_t(q), _t(inv))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    assert not np.array_equal(got.numpy(), inv)


def test_freeze_mask_matches_jax():
    """gibbs_scales freezes medium's tau and sampled obs noise sigma,
    and nothing else, as the JAX sampler does."""
    kw = dict(ncp=False, interweave=True, gibbs_scales=True, num_warmup=10,
              num_samples=10)
    js = jsampler._make_sampler(jsuite.medium_model(), **kw)
    ts = tsampler._make_sampler(tsuite.medium_model(), device="cpu", **kw)
    np.testing.assert_array_equal(ts._freeze_mask.numpy(), js._freeze_mask)
    assert float(ts._freeze_mask.sum()) == ts.model.size - 2


@pytest.mark.parametrize("eps", [0.3, 1.2])
def test_frozen_coordinate_through_transition(eps):
    """An inverse mass of exactly 0 keeps tau fixed through
    find_reasonable_epsilon and a whole transition (tree and U-turn
    checks), in lockstep with the JAX kernel."""
    max_depth, c = 6, 8
    jm, tm = _compiled("eight_schools")
    d = tm.size
    off = next(e.offset for e in tm.pm.entries if e.id == "tau")
    rng = np.random.default_rng(4)
    q = rng.uniform(-2, 2, size=(c, d)).astype(np.float32)
    inv = rng.uniform(0.5, 1.5, size=d).astype(np.float32)
    inv[off] = 0.0
    keys = jax.random.split(jax.random.PRNGKey(5), c)
    jmetric = jlf.make_metric(jnp.asarray(inv))
    jvag = jm.value_and_grad

    def one(qq, key):
        lp, g = jvag(qq)
        e0 = jss.find_reasonable_epsilon(jvag, qq, lp, g, key, jmetric)
        q1, _, _, st = jtree.nuts_transition(jvag, jmetric, eps, qq, lp, g,
                                             key, max_depth)
        return e0, q1, st

    je0, jq, jst = jax.jit(jax.vmap(one))(jnp.asarray(q), keys)
    z0 = jax.vmap(lambda k: jax.random.normal(k, (d,), jnp.float32))(keys)
    z, dirs, merges, leaves = _jax_randomness_fn(d, max_depth)(keys)
    metric = tlf.make_metric(_t(inv).expand(c, d))
    lp, g = tm.value_and_grad(_t(q))
    e0 = tss.find_reasonable_epsilon(tm.value_and_grad, _t(q), lp, g, metric,
                                     _t(z0))
    np.testing.assert_allclose(e0.numpy(), np.asarray(je0), rtol=1e-6)
    rand = {"r0_z": _t(z), "go_right": torch.as_tensor(np.array(dirs)),
            "merge_logu": _t(merges), "leaf_logu": _t(leaves)}
    tq, _, _, tst = ttree.nuts_transition(
        tm.value_and_grad, metric, torch.full((c,), eps), _t(q), lp, g,
        max_depth, rand=rand)
    for k in ("depth", "n_steps", "diverging"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(tq[:, off].numpy(), q[:, off])
    assert (tst["n_steps"] > 0).all()


def test_option_errors():
    ir = tsuite.eight_schools_model()
    with pytest.raises(ValueError, match="requires interweave"):
        tsampler._make_sampler(ir, ncp=False, device="cpu", gibbs_scales=True)
    with pytest.raises(ValueError, match="diag-metric only"):
        tsampler._make_sampler(ir, ncp=False, device="cpu", interweave=True,
                               gibbs_scales=True, dense_mass=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tsampler._make_sampler(ir, device="cpu", shared_warmup=True,
                               pooled_adaptation=True)
    b, d = exmc_tpu_torch.Builder, exmc_tpu_torch.dists
    plain = b.rv(b.new_ir(), "mu", d.Normal, {"mu": 0.0, "sigma": 1.0})
    with pytest.raises(ValueError, match="no eligible"):
        tsampler._make_sampler(plain, ncp=False, device="cpu", interweave=True)


def test_energy_recorded_post_interweave(monkeypatch):
    """tests/test_interweave.py:346: with a fake interweave that shifts q
    by +5, energy + logp stays the (nonnegative) kinetic energy on every
    recorded draw."""
    def fake_build(model):
        def step(q, generator=None, rand=None):
            return q + 5.0, torch.ones(q.shape[0], dtype=q.dtype)
        return step

    monkeypatch.setattr(tsampler, "build_interweave", fake_build)
    b, d = exmc_tpu_torch.Builder, exmc_tpu_torch.dists
    ir = b.rv(b.new_ir(), "z", d.Normal, {"mu": 0.0, "sigma": 1.7}, shape=(4,))
    _, stats = tsampler.sample(ir, num_chains=2, num_warmup=50,
                               num_samples=80, seed=0, interweave=True,
                               device="cpu")
    kinetic = stats["energy"] + stats["logp"]
    assert np.all(np.isfinite(kinetic))
    assert float(kinetic.min()) >= -1e-3, float(kinetic.min())
    # the fake's shift makes the pre-interweave recording far negative
    assert float(stats["logp"].mean()) < -20


def test_prior_exactness_with_interweave():
    """tests/test_interweave.py:61 at a small size: the prior
    s ~ GRW(sigma), sigma ~ HalfNormal(0.8), whose sigma marginal is
    known (mean 0.8 sqrt(2/pi), sd 0.8 sqrt(1 - 2/pi)); any error in the
    fiber move's acceptance biases it."""
    b, d = exmc_tpu_torch.Builder, exmc_tpu_torch.dists
    ir = b.rv(b.new_ir(), "sigma", d.HalfNormal, {"sigma": 0.8})
    ir = b.rv(ir, "s", d.GaussianRandomWalk, {"sigma": "sigma"}, shape=(30,))
    trace, stats = tsampler.sample(ir, num_chains=32, num_warmup=100,
                                   num_samples=200, seed=0, interweave=True,
                                   device="cpu")
    assert float(np.mean(stats["iw_accept"])) > 0.5
    sig = trace["sigma"]
    assert abs(float(sig.mean()) - 0.8 * np.sqrt(2.0 / np.pi)) < 0.03
    assert abs(float(sig.std()) - 0.8 * np.sqrt(1.0 - 2.0 / np.pi)) < 0.03


@pytest.mark.gpu
def test_interweave_and_suite_model_on_card():
    """On the card: the chi^2 draw of torch._standard_gamma with a CUDA
    generator has the chi^2_5 moments; one interweave step and the
    conditional metric add no host sync (CUDA's sync check raises on
    one) and equal the CPU step under the same injected draws; and one
    suite model runs a few iterations to finite draws."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    chi2 = 2.0 * torch._standard_gamma(torch.full((200_000,), 2.5, device="cuda"),
                                       generator=gen)
    assert abs(float(chi2.mean()) - 5.0) < 0.05
    assert abs(float(chi2.var()) - 10.0) < 0.3

    build, ncp = CASES["eight_schools"]
    cpu = tcompiler.compile_logp(build(exmc_tpu_torch), ncp=ncp, device="cpu")
    gpu = tcompiler.compile_logp(build(exmc_tpu_torch), ncp=ncp, device="cuda")
    q = _t(_points(64, cpu.size, 3))
    jm, _ = _compiled("eight_schools")
    rand = _jax_rand(jiw.eligible_groups(jm),
                     jax.random.split(jax.random.PRNGKey(2), 64))
    rand_gpu = [{k: v.cuda() for k, v in r.items()} for r in rand]
    step_gpu, metric_gpu = (tiw.build_interweave(gpu),
                            tiw.build_conditional_metric(gpu))
    qg = q.cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        q1, acc = step_gpu(qg, rand=rand_gpu)
        q2, _ = step_gpu(qg, generator=gen)
        inv = metric_gpu(q1, torch.ones_like(q1))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want_q, want_acc = tiw.build_interweave(cpu)(q, rand=rand)
    np.testing.assert_allclose(q1.cpu().numpy(), want_q.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(acc.cpu().numpy(), want_acc.numpy())
    q1c = q1.cpu()
    np.testing.assert_allclose(
        inv.cpu().numpy(),
        tiw.build_conditional_metric(cpu)(q1c, torch.ones_like(q1c)).numpy(),
        rtol=1e-5)
    assert torch.isfinite(q2).all()

    res = tsuite.run_model("sv", num_warmup=10, num_samples=10, device="cuda",
                           warm_up=(2, 2))
    assert res["all_finite"] and res["d"] == 102 and res["num_chains"] == 64
