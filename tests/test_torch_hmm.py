"""``exmc_tpu_torch.hmm`` against the JAX package and brute force: the
forward pass (the port's log-depth tree against JAX's scan, f32
relative 1e-5; batched leading axes), the forward-backward smoothing
probabilities (absolute 1e-5) and the Viterbi path (equal), and
``hmm_dist``'s compiled log-density and gradient against the JAX
model's at random points (relative 2e-5 and 1e-4). The counterparts of
``tests/test_hmm.py``'s NUTS tests are in ``tests/test_torch_hmm_fit.py``.
"""

import itertools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu import compiler as jcompiler
from exmc_tpu import hmm as jhmm
from exmc_tpu_torch.hmm import forward_logp, hmm_dist, posterior_state_probs, viterbi
from test_torch_families import one_torch_thread  # noqa: F401 (autouse)


def _norm_logpdf(y, mu, sigma):
    z = (y - mu) / sigma
    return -0.5 * z * z - np.log(sigma) - 0.5 * np.log(2 * np.pi)


def test_forward_matches_brute_force():
    rng = np.random.default_rng(0)
    T, K = 8, 2
    trans = np.array([[0.8, 0.2], [0.3, 0.7]])
    init = np.array([0.6, 0.4])
    mus, sigma = np.array([-1.0, 1.5]), 0.7
    y = rng.normal(size=T)
    log_obs = np.stack([_norm_logpdf(y, mus[k], sigma) for k in range(K)], axis=-1)
    got = float(forward_logp(torch.tensor(log_obs), torch.log(torch.tensor(trans)),
                             torch.log(torch.tensor(init))))
    total = -np.inf
    for path in itertools.product(range(K), repeat=T):
        lp = np.log(init[path[0]]) + log_obs[0, path[0]]
        for t in range(1, T):
            lp += np.log(trans[path[t - 1], path[t]]) + log_obs[t, path[t]]
        total = np.logaddexp(total, lp)
    assert got == pytest.approx(total, abs=1e-4)


@pytest.mark.parametrize("T,K", [(1, 2), (2, 3), (37, 3), (400, 2)])
def test_forward_matches_jax(T, K):
    rng = np.random.default_rng(T)
    lo = rng.normal(size=(3, T, K)).astype(np.float32) * 2.0
    lt = np.log(rng.dirichlet(np.ones(K), size=(3, K))).astype(np.float32)
    li = np.log(rng.dirichlet(np.ones(K), size=3)).astype(np.float32)
    want = np.asarray(jax.vmap(jhmm.forward_logp)(jnp.asarray(lo), jnp.asarray(lt),
                                                  jnp.asarray(li)))
    got = forward_logp(torch.tensor(lo), torch.tensor(lt), torch.tensor(li)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _gen(T, seed=0):
    rng = np.random.default_rng(seed)
    trans = np.array([[0.9, 0.1], [0.2, 0.8]])
    s = np.zeros(T, int)
    for t in range(1, T):
        s[t] = rng.choice(2, p=trans[s[t - 1]])
    return (np.array([-1.0, 1.5])[s] + 0.6 * rng.normal(size=T)).astype(np.float32), s


def _emission(pkg):
    log = jnp.log if pkg is exmc_tpu else torch.log

    def emission(y, k, params):
        z = (y - params["mus"][k]) / params["sigma"]
        return -0.5 * z * z - log(params["sigma"]) - 0.5 * np.log(2 * np.pi)

    return emission


@pytest.mark.parametrize("stationary", [True, False])
def test_smoothing_and_viterbi_match_jax(stationary):
    y, _ = _gen(150, seed=1)
    params = {"mus": np.array([-0.9, 1.4], np.float32), "sigma": np.float32(0.65),
              "trans": np.array([[0.85, 0.15], [0.25, 0.75]], np.float32),
              "init": np.array([0.3, 0.7], np.float32)}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    g_j = np.asarray(jhmm.posterior_state_probs(_emission(exmc_tpu), jnp.asarray(y), jp, 2,
                                                stationary_init=stationary))
    p_j = np.asarray(jhmm.viterbi(_emission(exmc_tpu), jnp.asarray(y), jp, 2,
                                  stationary_init=stationary))
    g_t = posterior_state_probs(_emission(exmc_tpu_torch), y, params, 2,
                                stationary_init=stationary, device="cpu")
    p_t = viterbi(_emission(exmc_tpu_torch), y, params, 2, stationary_init=stationary,
                  device="cpu")
    np.testing.assert_allclose(g_t.numpy(), g_j, atol=1e-5)
    assert p_t.dtype == torch.int32
    np.testing.assert_array_equal(p_t.numpy(), p_j)


def _model(pkg, y):
    stack = jnp.stack if pkg is exmc_tpu else torch.stack
    d = pkg.dists
    with pkg.Model() as m:
        m.rv("mus", d.Normal, {"mu": 0.0, "sigma": 3.0}, transform="ordered", shape=(2,))
        m.rv("sigma", d.HalfNormal, {"sigma": 2.0})
        m.rv("p00", d.Beta, {"alpha": 2.0, "beta": 2.0})
        m.rv("p11", d.Beta, {"alpha": 2.0, "beta": 2.0})
        m.det("trans", lambda a, b: stack([stack([a, 1 - a]), stack([1 - b, b])]),
              ["p00", "p11"])
        m.rv("y", pkg.hmm.hmm_dist(_emission(pkg), 2, stationary_init=True),
             {"trans": "trans", "mus": "mus", "sigma": "sigma"})
        m.obs("y_obs", "y", y)
    return m.ir


def test_hmm_dist_logp_matches_jax():
    y, _ = _gen(120, seed=2)
    jc = jcompiler.compile_logp(_model(exmc_tpu, y))
    tc = exmc_tpu_torch.compile_logp(_model(exmc_tpu_torch, y), device="cpu")
    assert tc.size == jc.size
    x = np.random.default_rng(3).uniform(-1.0, 1.0, size=(5, tc.size)).astype(np.float32)
    jl, jg = jax.vmap(lambda f: jc.value_and_grad(f, jc.data))(jnp.asarray(x))
    tl, tg = tc.value_and_grad(torch.as_tensor(x))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5)
    # the gradient flows back through T - 1 contractions summed in
    # another order than the scan's: relative 1e-4
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4, atol=2e-4)
    # one chain's density does not depend on the others in its batch
    tl1, _ = tc.value_and_grad(torch.as_tensor(x[2:3]))
    np.testing.assert_allclose(tl1.numpy(), tl.numpy()[2:3], rtol=1e-6)


def test_hmm_dist_needs_init_unless_stationary():
    y, _ = _gen(20)
    with exmc_tpu_torch.Model() as m:
        m.rv("mus", exmc_tpu_torch.dists.Normal, {"mu": 0.0, "sigma": 3.0}, shape=(2,))
        m.rv("y", hmm_dist(_emission(exmc_tpu_torch), 2),
             {"trans": np.array([[0.9, 0.1], [0.2, 0.8]]), "mus": "mus", "sigma": 1.0})
        m.obs("y_obs", "y", y)
    model = exmc_tpu_torch.compile_logp(m.ir, device="cpu")
    with pytest.raises(ValueError, match="init"):
        model.value_and_grad(torch.zeros(2, model.size))
