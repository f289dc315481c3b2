"""The port's NUTS tree (``exmc_tpu_torch/nuts/tree.py``) held to the
C++ recursive oracle and to the JAX package's tree property and
exact-invariance batteries, run on the port's tree on the CPU.

* Forced-direction lockstep (``tests/test_native_tree.py``'s matched-RNG
  lockstep, on the port): per trial the momentum draw and the
  per-doubling direction bits are extracted on the host from the JAX
  kernel's key-split discipline and injected into the port's batched
  transition (all 300 trials are one batch of chains); the same
  directions are forced into ``exmc_tpu_torch.native.build_full_tree`` on
  f64 leapfrog chains precomputed from the same start. Tree shape is a
  deterministic function of geometry and directions, so depth,
  leapfrog count and the divergence flag must be EXACTLY equal; the
  mean accept statistic within 5e-4 (f32 against f64 arithmetic).
* ``tests/test_tree_properties.py``'s first five tests. The JAX tests
  run one chain for n iterations (``lax.scan``); here a batch of chains
  runs n / chains iterations each, the same number of draws, and the
  same statistics are asserted.
* ``tests/test_exact_invariance.py``'s five tests, with the same
  N_CHAINS = 8192, R = 4, K = 8, Holm alpha 0.005, targets and step
  sizes; exact initial states come from a seeded torch generator. The
  battery (KS p-values, Stouffer, Holm) is the one the card's
  ``tree:invariance`` task runs (``benchmarks/families.py``).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from exmc_tpu_torch import native
from exmc_tpu.nuts.leapfrog import make_metric as jmake_metric
from exmc_tpu.nuts.leapfrog import sample_momentum as jsample_momentum
from exmc_tpu_torch.benchmarks.families import (
    battery_pvalues,
    holm_reject,
    invariance_run,
    stouffer,
)
from exmc_tpu_torch.nuts.leapfrog import make_metric
from exmc_tpu_torch.nuts.tree import nuts_transition
from test_torch_families import one_torch_thread  # noqa: F401 (autouse)


def _iso_vag(q):
    return -0.5 * torch.sum(q * q, dim=-1), -q


# ---------------------------------------------------------------------------
# forced-direction lockstep against the C++ oracle
# ---------------------------------------------------------------------------

def _leapfrog_chain(q0, p0, eps, n, inv_mass):
    """An n-step f64 leapfrog chain on the standard Gaussian."""
    qs, ps, lps = [], [], []
    q, p = q0.copy(), p0.copy()
    g = -q
    for _ in range(n):
        p_half = p + 0.5 * eps * g
        q = q + eps * inv_mass * p_half
        g = -q
        p = p_half + 0.5 * eps * g
        qs.append(q.copy())
        ps.append(p.copy())
        lps.append(-0.5 * float(q @ q))
    return np.array(qs), np.array(ps), np.array(lps)


def _host_randomness(keys, d, max_depth):
    """The JAX transition's draws per key: momentum normals, direction
    bits, merge and leaf log-uniforms (key, mom = split(key); per
    doubling key, dir, sub, merge = split(key, 4); per leaf
    sub, take = split(sub))."""

    def leaf(sk, _):
        sk, tk = jax.random.split(sk)
        return sk, -jax.random.exponential(tk)

    def gen(key):
        key, mom = jax.random.split(key)
        z = jax.random.normal(mom, (d,), jnp.float32)
        dirs, merges, leaves = [], [], []
        for _ in range(max_depth):
            key, dk, sk, mk = jax.random.split(key, 4)
            dirs.append(jax.random.bernoulli(dk))
            merges.append(-jax.random.exponential(mk))
            leaves.append(jax.lax.scan(leaf, sk, None, length=2 ** (max_depth - 1))[1])
        return z, jnp.stack(dirs), jnp.stack(merges), jnp.stack(leaves)

    return [np.array(a) for a in jax.jit(jax.vmap(gen))(keys)]


def test_forced_direction_lockstep_with_cpp_oracle():
    if not native.available():
        pytest.skip("native toolchain unavailable")
    d, eps, max_depth, n_trials = 2, 0.45, 6, 300
    q0 = np.array([0.7, -0.4])
    inv_mass = np.ones(d)
    keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(42), t)
                      for t in range(n_trials)])
    z, dirs, merges, leaves = _host_randomness(keys, d, max_depth)
    # the host mirror of the JAX kernel's momentum: equal to z at a unit metric
    jmetric = jmake_metric(jnp.ones(d, jnp.float32))
    _, mom0 = jax.random.split(keys[0])
    np.testing.assert_array_equal(np.asarray(jsample_momentum(mom0, jmetric, d)), z[0])

    q = torch.as_tensor(np.tile(q0, (n_trials, 1)), dtype=torch.float32)
    logp, grad = _iso_vag(q)
    rand = {"r0_z": torch.as_tensor(z), "go_right": torch.as_tensor(dirs),
            "merge_logu": torch.as_tensor(merges), "leaf_logu": torch.as_tensor(leaves)}
    _, _, _, stats = nuts_transition(
        _iso_vag, make_metric(torch.ones(n_trials, d)), torch.full((n_trials,), eps),
        q, logp, grad, max_depth, rand=rand)

    depths_seen = set()
    for t in range(n_trials):
        r0 = z[t].astype(np.float64)
        fwd = _leapfrog_chain(q0, r0, eps, 2 ** max_depth, inv_mass)
        bwd = _leapfrog_chain(q0, r0, -eps, 2 ** max_depth, inv_mass)
        forced = [1 if b else -1 for b in dirs[t]]
        out = native.build_full_tree(q0, r0, -0.5 * float(q0 @ q0), fwd, bwd, inv_mass,
                                     max_depth=max_depth, seed=t, dirs=forced)
        assert out["ok"]
        assert out["depth"] == int(stats["depth"][t]), (t, forced)
        assert out["n_leapfrog"] == int(stats["n_steps"][t]), (t, forced)
        assert out["diverging"] == bool(stats["diverging"][t]), t
        assert abs(out["accept_prob"] - float(stats["accept_prob"][t])) < 5e-4, t
        depths_seen.add(out["depth"])
    assert len(depths_seen) >= 3


# ---------------------------------------------------------------------------
# tests/test_tree_properties.py on the port's tree
# ---------------------------------------------------------------------------

def run_chains(vag, d, eps, n_iters, seed, chains, inv=None, max_depth=10):
    """``chains`` chains from 0 for ``n_iters`` transitions: draws
    (chains, n_iters, d) and stats (chains, n_iters)."""
    inv = torch.ones(chains, d) if inv is None else inv
    metric = make_metric(inv)
    gen = torch.Generator().manual_seed(seed)
    q = torch.zeros(chains, d)
    logp, grad = vag(q)
    eps_t = torch.full((chains,), float(eps))
    qs, stats = [], []
    for _ in range(n_iters):
        q, logp, grad, s = nuts_transition(vag, metric, eps_t, q, logp, grad, max_depth,
                                           generator=gen)
        qs.append(q)
        stats.append(s)
    return (torch.stack(qs, 1).numpy(),
            {k: torch.stack([s[k] for s in stats], 1).numpy() for k in stats[0]})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_anisotropic_gaussian_invariants(seed):
    """Random per-coordinate scales in [0.3, 3]: accept in a sane band,
    few divergences, diverse proposals, every marginal variance
    recovered (16 chains x 125 transitions = the JAX test's 2000)."""
    rng = np.random.default_rng(seed)
    d = int(rng.integers(2, 8))
    scales = torch.as_tensor(rng.uniform(0.3, 3.0, size=d), dtype=torch.float32)

    def vag(q):
        z = q / scales
        return -0.5 * torch.sum(z * z, dim=-1), -q / (scales * scales)

    eps = 0.3 * float(scales.min())
    qs, stats = run_chains(vag, d, eps, 125, seed + 100, chains=16)
    qs = qs[:, 25:]
    assert 0.6 < stats["accept_prob"].mean() <= 1.0
    assert stats["diverging"].mean() < 0.02
    moved = np.mean(np.any(np.diff(qs, axis=1) != 0, axis=2))
    assert moved > 0.9
    np.testing.assert_allclose(qs.reshape(-1, d).var(axis=0), scales.numpy() ** 2,
                               rtol=0.35)


def test_depth_scales_with_condition_number():
    """A badly conditioned target needs deeper trees at a fixed eps."""
    scales = torch.tensor([1.0, 10.0])

    def vag_aniso(q):
        z = q / scales
        return -0.5 * torch.sum(z * z, dim=-1), -q / (scales * scales)

    _, s_iso = run_chains(_iso_vag, 2, 0.3, 75, 5, chains=8)
    _, s_aniso = run_chains(vag_aniso, 2, 0.3, 75, 5, chains=8)
    assert s_aniso["depth"].mean() > s_iso["depth"].mean() + 0.5


def test_energy_stats_centered():
    """E[energy change] across transitions ~ 0 for a well-tuned chain."""
    _, stats = run_chains(_iso_vag, 4, 0.5, 220, 9, chains=10)
    de = np.diff(stats["energy"][:, 20:], axis=1)
    assert abs(de.mean()) < 0.05


def _free_particle(q):
    return torch.zeros(q.shape[0]), torch.zeros_like(q)


def test_max_depth_respected():
    _, stats = run_chains(_free_particle, 2, 0.1, 50, 11, chains=1, max_depth=6)
    assert stats["depth"].max() == 6
    assert stats["n_steps"].max() <= 2 ** 6


def test_dynamic_depth_cap():
    q = torch.zeros(1, 2)
    logp, grad = _free_particle(q)
    _, _, _, stats = nuts_transition(
        _free_particle, make_metric(torch.ones(1, 2)), torch.full((1,), 0.1), q, logp,
        grad, 10, max_depth_dyn=3, generator=torch.Generator().manual_seed(0))
    assert int(stats["depth"][0]) == 3


# ---------------------------------------------------------------------------
# tests/test_exact_invariance.py on the port's tree
# ---------------------------------------------------------------------------

CPU = torch.device("cpu")
N_CHAINS = 8192
R_REPL = 4
K_STEPS = 8


def _replicated_battery(vag, d, eps, base_seed, chol=None, cov=None):
    pmat = []
    for r in range(R_REPL):
        x, acc = invariance_run(vag, d, eps, base_seed + 1000 * r, CPU, N_CHAINS, K_STEPS,
                                chol=chol)
        assert 0.5 < acc < 1.0
        pmat.append(battery_pvalues(x, cov))
    return stouffer(pmat), np.asarray(pmat)


def test_invariance_iso_gaussian():
    pcomb, pmat = _replicated_battery(_iso_vag, 4, eps=0.7, base_seed=0)
    assert not holm_reject(pcomb), (pcomb, pmat)


def test_invariance_correlated_gaussian():
    d, rho = 3, 0.8
    cov = np.full((d, d), rho) + (1 - rho) * np.eye(d)
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32)

    def vag(q):
        pq = q @ prec
        return -0.5 * torch.sum(q * pq, dim=-1), -pq

    pcomb, pmat = _replicated_battery(vag, d, eps=0.35, base_seed=2,
                                      chol=np.linalg.cholesky(cov), cov=cov)
    assert not holm_reject(pcomb), (pcomb, pmat)


def test_battery_detects_inflated_sd():
    """Negative control: a consistent 15% sd inflation rejects."""
    rng = np.random.default_rng(2)
    pmat = [battery_pvalues(rng.normal(scale=1.15, size=(N_CHAINS, 4)))
            for _ in range(R_REPL)]
    assert holm_reject(stouffer(pmat))


def test_battery_detects_mode_bias():
    """Negative control for mode-biased selection: a 10% radial shrink
    rejects through the chi2 radius test."""
    rng = np.random.default_rng(3)
    pmat = [battery_pvalues(rng.normal(size=(N_CHAINS, 4)) * 0.9)
            for _ in range(R_REPL)]
    assert holm_reject(stouffer(pmat))


def test_stouffer_dilutes_single_fluke():
    """One extreme replicate among otherwise-null ones does not reject."""
    pmat = np.array([
        [4e-5, 0.5, 0.5, 0.5, 0.5, 0.5],
        [0.4, 0.6, 0.3, 0.7, 0.5, 0.5],
        [0.5, 0.5, 0.6, 0.4, 0.5, 0.5],
        [0.6, 0.4, 0.5, 0.5, 0.5, 0.5],
    ])
    assert not holm_reject(stouffer(pmat))
