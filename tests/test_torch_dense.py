"""The dense metric in the port against the JAX package: the metric's
velocity, kinetic energy and momentum draw, the dense Welford state,
its Chan merge across chains and its finalize, find_reasonable_epsilon,
a one-transition lockstep of the tree under a dense metric with the JAX
kernel's randomness injected, and a short dense_mass run.

Tolerance: float32, 1e-5 relative (1e-4 absolute on positions) unless a
case states its own."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from exmc_tpu.nuts import leapfrog as jlf
from exmc_tpu.nuts import mass_matrix as jmm
from exmc_tpu.nuts import step_size as jss
from exmc_tpu.nuts import tree as jtree
from exmc_tpu_torch import Builder, dists
from exmc_tpu_torch.interop import tuning_from_numpy
from exmc_tpu_torch.nuts import leapfrog as tlf
from exmc_tpu_torch.nuts import mass_matrix as tmm
from exmc_tpu_torch.nuts import sampler as tsampler
from exmc_tpu_torch.nuts import step_size as tss
from exmc_tpu_torch.nuts import tree as ttree
from test_torch_nuts import _jax_randomness_fn, _models


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _spd(d, seed):
    a = np.random.default_rng(seed).normal(size=(d, d))
    return (a @ a.T / d + 0.5 * np.eye(d)).astype(np.float32)


def _chain_spds(c, d, seed):
    return np.stack([_spd(d, seed + i) for i in range(c)])


def test_dense_metric_ops_match_jax():
    c, d = 6, 4
    inv = _chain_spds(c, d, 0)
    p = np.random.default_rng(1).normal(size=(c, d)).astype(np.float32)
    metric = tlf.make_metric(_t(inv), dense=True)
    assert metric.dense
    jm = jax.vmap(jlf.make_metric)(jnp.asarray(inv))
    np.testing.assert_allclose(metric.chol_inv.numpy(), np.asarray(jm.chol_inv), rtol=1e-5,
                               atol=1e-6)
    vel = jax.vmap(jlf.velocity)(jm, jnp.asarray(p))
    np.testing.assert_allclose(tlf.velocity(metric, _t(p)).numpy(), np.asarray(vel),
                               rtol=1e-5, atol=1e-6)
    rows = np.random.default_rng(2).normal(size=(c, 3, d)).astype(np.float32)
    np.testing.assert_allclose(
        tlf.velocity_rows(metric, _t(rows)).numpy(),
        np.einsum("cij,ckj->cki", inv, rows), rtol=1e-5, atol=1e-5)
    ke = jax.vmap(jlf.kinetic_energy)(jm, jnp.asarray(p))
    np.testing.assert_allclose(tlf.kinetic_energy(metric, _t(p)).numpy(), np.asarray(ke),
                               rtol=1e-5)
    keys = jax.random.split(jax.random.PRNGKey(3), c)
    p_ref = jax.vmap(lambda k, m: jlf.sample_momentum(k, m, d))(keys, jm)
    z = jax.vmap(lambda k: jax.random.normal(k, (d,), jnp.float32))(keys)
    np.testing.assert_allclose(tlf.sample_momentum(metric, _t(z)).numpy(), np.asarray(p_ref),
                               rtol=1e-5, atol=1e-5)


def test_dense_welford_update_and_finalize_match_jax():
    rng = np.random.default_rng(4)
    c, d, n = 5, 3, 40
    xs = rng.normal(size=(n, c, d)).astype(np.float32) @ np.linalg.cholesky(_spd(d, 5)).T
    en = rng.uniform(size=(n, c)) > 0.2
    jst = jax.vmap(lambda _: jmm.welford_init(d, dense=True))(jnp.arange(c))
    tst = tmm.welford_init(c, d, dense=True)
    assert tst.m2.shape == (c, d, d)
    upd = jax.jit(jax.vmap(jmm.welford_update))
    for x, e in zip(xs, en):
        jst = upd(jst, jnp.asarray(x), jnp.asarray(e))
        tst = tmm.welford_update(tst, _t(x), torch.as_tensor(e))
    for g, w in zip(tst, jst):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    prev = np.broadcast_to(np.eye(d, dtype=np.float32), (c, d, d))
    ref = jax.vmap(jmm.welford_finalize)(jst, jnp.asarray(prev))
    np.testing.assert_allclose(tmm.welford_finalize(tst, _t(prev)).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    # fewer than 2 draws keeps the previous metric
    one = tmm.welford_update(tmm.welford_init(c, d, dense=True), _t(xs[0]),
                             torch.ones(c, dtype=torch.bool))
    np.testing.assert_array_equal(tmm.welford_finalize(one, _t(prev)).numpy(), prev)


def test_dense_welford_merge_matches_jax_psum():
    """The Chan merge over chains against the JAX merge over a vmapped
    axis (psum), and against one stream of every chain's draws."""
    rng = np.random.default_rng(6)
    c, d, n = 6, 3, 25
    xs = rng.normal(loc=2.0, size=(n, c, d)).astype(np.float32)
    en = rng.uniform(size=(n, c)) > 0.3
    jst = jax.vmap(lambda _: jmm.welford_init(d, dense=True))(jnp.arange(c))
    tst = tmm.welford_init(c, d, dense=True)
    for x, e in zip(xs, en):
        jst = jax.vmap(jmm.welford_update)(jst, jnp.asarray(x), jnp.asarray(e))
        tst = tmm.welford_update(tst, _t(x), torch.as_tensor(e))
    jmerged = jax.vmap(lambda s: jmm.welford_merge_across(s, "c"), axis_name="c")(jst)
    merged = tmm.welford_merge_across(tst)
    for g, w in zip(merged, jmerged):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[0], rtol=1e-4, atol=1e-4)
    flat = xs[en]
    np.testing.assert_allclose(merged.m2.numpy() / (merged.n.numpy() - 1),
                               np.cov(flat.T), rtol=1e-4, atol=1e-5)
    fin = tmm.welford_finalize(merged, torch.eye(d).expand(c, d, d))
    assert fin.shape == (c, d, d)


def test_find_reasonable_epsilon_dense_matches_jax():
    jvag, tvag, d = _models("eight_schools")
    c = 8
    q = np.random.default_rng(7).uniform(-2, 2, size=(c, d)).astype(np.float32)
    inv = _spd(d, 8)
    keys = jax.random.split(jax.random.PRNGKey(9), c)
    jmetric = jlf.make_metric(jnp.asarray(inv))

    def one(qq, key):
        lp, g = jvag(qq)
        return jss.find_reasonable_epsilon(jvag, qq, lp, g, key, jmetric)

    ref = jax.jit(jax.vmap(one))(jnp.asarray(q), keys)
    z = jax.vmap(lambda k: jax.random.normal(k, (d,), jnp.float32))(keys)
    lp, g = tvag(_t(q))
    got = tss.find_reasonable_epsilon(
        tvag, _t(q), lp, g, tlf.make_metric(_t(inv).expand(c, d, d), dense=True), _t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("model,eps", [("gauss2", 0.6), ("gauss2", 1.4),
                                       ("eight_schools", 0.3)])
def test_tree_lockstep_dense_metric(model, eps):
    """The port's transition and the JAX kernel under the same dense
    metric and injected randomness build the same tree per chain: equal
    depth, leapfrog count and divergence; the same accept_prob, energy
    and draw."""
    max_depth, c = 6, 8
    jvag, tvag, d = _models(model)
    rng = np.random.default_rng(10)
    q = rng.uniform(-2, 2, size=(c, d)).astype(np.float32)
    inv = _spd(d, 11)
    keys = jax.random.split(jax.random.PRNGKey(12), c)

    def one(qq, key):
        lp, g = jvag(qq)
        q1, _, _, st = jtree.nuts_transition(jvag, jlf.make_metric(jnp.asarray(inv)),
                                             jnp.float32(eps), qq, lp, g, key, max_depth)
        return q1, st

    jq, jst = jax.jit(jax.vmap(one))(jnp.asarray(q), keys)
    z, dirs, merges, leaves = _jax_randomness_fn(d, max_depth)(keys)
    rand = {"r0_z": _t(z), "go_right": torch.as_tensor(np.array(dirs)),
            "merge_logu": _t(merges), "leaf_logu": _t(leaves)}
    lp, g = tvag(_t(q))
    tq, _, _, tst = ttree.nuts_transition(
        tvag, tlf.make_metric(_t(inv).expand(c, d, d).contiguous(), dense=True),
        torch.full((c,), eps), _t(q), lp, g, max_depth, rand=rand)
    for k in ("depth", "n_steps", "diverging"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]), err_msg=k)
    for k in ("accept_prob", "energy"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   rtol=1e-5, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-4)


def test_dense_mass_run_and_option_checks():
    """dense_mass=True samples a correlated Gaussian with a (C, d, d)
    adapted inverse mass near its covariance; gibbs_scales stays refused
    with it."""
    d, rho = 3, 0.9
    cov = rho * np.ones((d, d)) + (1 - rho) * np.eye(d)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "x", dists.MvNormal, {"mu": np.zeros(d), "cov": cov})
    trace, stats = tsampler.sample(ir, num_chains=8, seed=3, num_warmup=150,
                                   num_samples=100, dense_mass=True, device="cpu")
    assert trace["x"].shape == (8, 100, d) and np.isfinite(trace["x"]).all()
    assert stats["inv_mass"].shape == (8, d, d)
    np.testing.assert_allclose(stats["inv_mass"].mean(0), cov, atol=0.35)
    np.testing.assert_allclose(np.cov(trace["x"].reshape(-1, d).T), cov, atol=0.3)
    with pytest.raises(ValueError, match="diag-metric only"):
        tsampler._make_sampler(ir, device="cpu", interweave=True, gibbs_scales=True,
                               dense_mass=True)


def test_tuning_from_numpy_dense():
    inv = _chain_spds(4, 3, 20)
    eps, metric = tuning_from_numpy(np.full(4, 0.3), inv, device="cpu")
    assert metric.dense and metric.chol_inv.shape == (4, 3, 3)
    eps, metric = tuning_from_numpy(np.full(4, 0.3), inv[0], device="cpu", dense=True)
    assert metric.dense and metric.inv.shape == (4, 3, 3)
    _, diag = tuning_from_numpy(np.full(4, 0.3), np.ones((4, 3)), device="cpu")
    assert not diag.dense
