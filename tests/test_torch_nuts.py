"""The port's NUTS building blocks and tree against the JAX package on
the same inputs: leapfrog, dual averaging, find_reasonable_epsilon,
Welford, the warmup schedule, and a lockstep of the whole transition
with the JAX kernel's randomness injected into the port."""

from functools import lru_cache

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu import compiler as jcompiler
from exmc_tpu.nuts import leapfrog as jlf
from exmc_tpu.nuts import mass_matrix as jmm
from exmc_tpu.nuts import sampler as jsampler
from exmc_tpu.nuts import step_size as jss
from exmc_tpu.nuts import tree as jtree
from exmc_tpu.nuts import warmup as jwarmup
from exmc_tpu_torch import compiler as tcompiler
from exmc_tpu_torch.nuts import leapfrog as tlf
from exmc_tpu_torch.nuts import mass_matrix as tmm
from exmc_tpu_torch.nuts import sampler as tsampler
from exmc_tpu_torch.nuts import step_size as tss
from exmc_tpu_torch.nuts import tree as ttree
from exmc_tpu_torch.nuts import warmup as twarmup

Y8 = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
S8 = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]


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


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _models(name):
    """(jax single-point vag, port batched vag, d) of a test model."""
    if name == "gauss2":
        return ((lambda q: (-0.5 * jnp.sum(q * q), -q)),
                (lambda q: (-0.5 * torch.sum(q * q, dim=-1), -q)), 2)
    jm = jcompiler.compile_logp(eight_schools(exmc_tpu))
    tm = tcompiler.compile_logp(eight_schools(exmc_tpu_torch), device="cpu")
    return jm.value_and_grad, tm.value_and_grad, tm.size


def test_leapfrog_matches_jax():
    jvag, tvag, d = _models("eight_schools")
    rng = np.random.default_rng(0)
    q = rng.uniform(-2, 2, size=(8, d)).astype(np.float32)
    p = rng.normal(size=(8, d)).astype(np.float32)
    inv = rng.uniform(0.5, 1.5, size=d).astype(np.float32)
    eps = rng.uniform(0.05, 0.3, size=8).astype(np.float32)
    jmetric = jlf.make_metric(jnp.asarray(inv))

    def one(q, p, e):
        lp, g = jvag(q)
        return jlf.leapfrog(jvag, q, p, g, e, jmetric)

    ref = jax.jit(jax.vmap(one))(jnp.asarray(q), jnp.asarray(p), jnp.asarray(eps))
    _, g0 = tvag(_t(q))
    got = tlf.leapfrog(tvag, _t(q), _t(p), g0, _t(eps)[:, None],
                       tlf.make_metric(_t(inv)))
    for g, w in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-4)
    ke = tlf.kinetic_energy(tlf.make_metric(_t(inv)), _t(p))
    ke_ref = jax.vmap(lambda pp: jlf.kinetic_energy(jmetric, pp))(jnp.asarray(p))
    np.testing.assert_allclose(ke.numpy(), np.asarray(ke_ref), rtol=1e-6)


def test_sample_momentum_freezes_zero_inverse_mass():
    inv = _t([1.0, 0.0, 4.0])
    z = _t(np.random.default_rng(1).normal(size=(5, 3)))
    p = tlf.sample_momentum(tlf.make_metric(inv), z)
    ref = jax.vmap(lambda zz: jnp.where(jnp.sqrt(jnp.asarray(inv.numpy())) > 0,
                                        zz / jnp.sqrt(jnp.asarray(inv.numpy())),
                                        0.0))(jnp.asarray(z.numpy()))
    np.testing.assert_array_equal(p.numpy(), np.asarray(ref))
    assert (p[:, 1] == 0).all()


def test_dual_averaging_matches_jax():
    rng = np.random.default_rng(2)
    eps0 = rng.uniform(0.1, 2.0, size=6).astype(np.float32)
    accepts = rng.uniform(0, 1, size=(30, 6)).astype(np.float32)
    accepts[5, 2] = np.nan
    jst = jax.vmap(jss.da_init)(jnp.asarray(eps0))
    tst = tss.da_init(_t(eps0))
    upd = jax.jit(jax.vmap(lambda s, a: jss.da_update(s, a, 0.8)))
    for a in accepts:
        jst = upd(jst, jnp.asarray(a))
        tst = tss.da_update(tst, _t(a), 0.8)
        for g, w in zip(tst, jst):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tss.da_finalize(tst).numpy(),
                               np.asarray(jax.vmap(jss.da_finalize)(jst)), rtol=1e-5)


def test_find_reasonable_epsilon_matches_jax():
    jvag, tvag, d = _models("eight_schools")
    c = 8
    q = np.random.default_rng(3).uniform(-2, 2, size=(c, d)).astype(np.float32)
    inv = np.random.default_rng(4).uniform(0.5, 1.5, size=d).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), c)
    jmetric = jlf.make_metric(jnp.asarray(inv))

    def one(qq, key):
        lp, g = jvag(qq)
        return jss.find_reasonable_epsilon(jvag, qq, lp, g, key, jmetric)

    ref = jax.jit(jax.vmap(one))(jnp.asarray(q), keys)
    z = jax.vmap(lambda k: jax.random.normal(k, (d,), jnp.float32))(keys)
    lp, g = tvag(_t(q))
    got = tss.find_reasonable_epsilon(tvag, _t(q), lp, g,
                                      tlf.make_metric(_t(inv)), _t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_welford_update_and_finalize_match_jax():
    rng = np.random.default_rng(6)
    c, d, n = 5, 3, 40
    xs = rng.normal(size=(n, c, d)).astype(np.float32)
    en = rng.uniform(size=(n, c)) > 0.2
    jst = jax.vmap(lambda _: jmm.welford_init(d))(jnp.arange(c))
    tst = tmm.welford_init(c, d)
    upd = jax.jit(jax.vmap(jmm.welford_update))
    for x, e in zip(xs, en):
        jst = upd(jst, jnp.asarray(x), jnp.asarray(e))
        tst = tmm.welford_update(tst, _t(x), torch.as_tensor(e))
    for g, w in zip(tst, jst):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    prev = np.ones((c, d), np.float32)
    ref = jax.vmap(jmm.welford_finalize)(jst, jnp.asarray(prev))
    np.testing.assert_allclose(tmm.welford_finalize(tst, _t(prev)).numpy(),
                               np.asarray(ref), rtol=1e-5)


def test_welford_merge_equals_one_stream():
    """Chan merge over C chains == one Welford stream over all draws."""
    rng = np.random.default_rng(7)
    c, d, n = 6, 4, 25
    xs = rng.normal(loc=3.0, size=(n, c, d)).astype(np.float32)
    en = rng.uniform(size=(n, c)) > 0.3
    per_chain = tmm.welford_init(c, d)
    for x, e in zip(xs, en):
        per_chain = tmm.welford_update(per_chain, _t(x), torch.as_tensor(e))
    merged = tmm.welford_merge_across(per_chain)
    one = tmm.welford_init(1, d)
    for x, e in zip(xs, en):
        for i in np.flatnonzero(e):
            one = tmm.welford_update(one, _t(x[i:i + 1]), torch.ones(1, dtype=torch.bool))
    assert float(merged.n) == float(one.n[0]) == en.sum()
    np.testing.assert_allclose(merged.mean.numpy(), one.mean[0].numpy(), rtol=1e-5)
    np.testing.assert_allclose(merged.m2.numpy(), one.m2[0].numpy(), rtol=1e-4)
    prev = torch.ones(c, d)
    fin = tmm.welford_finalize(merged, prev)
    assert fin.shape == (c, d)
    np.testing.assert_allclose(fin.numpy(), np.broadcast_to(
        tmm.welford_finalize(one, prev[:1]).numpy(), (c, d)), rtol=1e-4)


@pytest.mark.parametrize("num_warmup", [0, 10, 60, 150, 200, 1000])
def test_schedule_and_pipeline_flags_identical(num_warmup):
    js = jwarmup.build_schedule(num_warmup, 10)
    ts = twarmup.build_schedule(num_warmup, 10)
    for f in ("update_mass", "window_end", "depth_cap"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    jxs = jsampler._pipeline_xs(js, 30, 10)
    txs = tsampler._pipeline_xs(ts, 30, 10)
    # the JAX tuple's 7th entry is the streaming flag, not ported
    for a, b in zip(txs, jxs[:6] + jxs[7:]):
        np.testing.assert_array_equal(a, b)


@lru_cache(maxsize=None)
def _jax_randomness_fn(d, max_depth):
    """Mirror of nuts_transition's key discipline, per chain:
    key, mom = split(key); per doubling key, dir, sub, merge = split(key, 4);
    per leaf sub, take = split(sub); log-uniforms are -Exponential."""

    def gen(key):
        key, mom = jax.random.split(key)
        z = jax.random.normal(mom, (d,), jnp.float32)
        dirs, merges, leaves = [], [], []
        for _ in range(max_depth):
            key, dk, sk, mk = jax.random.split(key, 4)
            dirs.append(jax.random.bernoulli(dk))
            merges.append(-jax.random.exponential(mk))
            row = []
            for _ in range(2 ** (max_depth - 1)):
                sk, tk = jax.random.split(sk)
                row.append(-jax.random.exponential(tk))
            leaves.append(jnp.stack(row))
        return z, jnp.stack(dirs), jnp.stack(merges), jnp.stack(leaves)

    return jax.jit(jax.vmap(gen))


@lru_cache(maxsize=None)
def _jax_transition_fn(model, max_depth):
    """The JAX kernel vmapped over chains; eps and the inverse mass are
    arguments, so one compile serves every case of a model."""
    jvag, _, _ = _models(model)

    def one(qq, key, eps, inv):
        lp, g = jvag(qq)
        q1, _, _, st = jtree.nuts_transition(jvag, jlf.make_metric(inv), eps,
                                             qq, lp, g, key, max_depth)
        return q1, st

    return jax.jit(jax.vmap(one, in_axes=(0, 0, None, None)))


@pytest.mark.parametrize("model,eps", [("gauss2", 0.45), ("gauss2", 1.3),
                                       ("gauss2", 2.5),
                                       ("eight_schools", 0.4)])
def test_tree_lockstep_with_injected_randomness(model, eps):
    """The port's batched transition and the JAX kernel (vmapped over the
    same keys) build the same tree per chain: equal depth, leapfrog
    count and divergence; the same accept_prob, energy and draw."""
    max_depth, c = 6, 8
    _, tvag, d = _models(model)
    rng = np.random.default_rng(11)
    q = rng.uniform(-2, 2, size=(c, d)).astype(np.float32)
    inv = rng.uniform(0.5, 1.5, size=d).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(12), c)

    jq, jst = _jax_transition_fn(model, max_depth)(
        jnp.asarray(q), keys, jnp.float32(eps), jnp.asarray(inv))
    z, dirs, merges, leaves = _jax_randomness_fn(d, max_depth)(keys)
    rand = {"r0_z": _t(z), "go_right": torch.as_tensor(np.array(dirs)),
            "merge_logu": _t(merges), "leaf_logu": _t(leaves)}
    lp, g = tvag(_t(q))
    tq, _, _, tst = ttree.nuts_transition(
        tvag, tlf.make_metric(_t(inv).expand(c, d)), torch.full((c,), eps),
        _t(q), lp, g, max_depth, rand=rand)
    for k in ("depth", "n_steps", "diverging"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]), err_msg=k)
    for k in ("accept_prob", "energy"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   rtol=1e-6, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6, atol=1e-4)
