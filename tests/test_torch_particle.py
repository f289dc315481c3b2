"""``exmc_tpu_torch.particle`` against the JAX package and the exact
Kalman quantities of the linear-Gaussian state-space model:

* ``systematic_resample``'s indices bit-equal to JAX's given the same
  offset u0 (extracted from JAX's key), and its counts tracking the
  weights;
* a bootstrap-filter lockstep: the JAX filter's initial draws, step
  noises and resampling offsets extracted from its key splits and
  injected into the port's filter (the model callables read them by
  t), giving the same log-marginal (absolute 1e-3), filtered means
  and ESS (1e-4);
* the counterparts of ``tests/test_particle.py``'s five tests, at their
  sizes and gates (PMMH with 4 chains x 600, SMC^2 with 128 x 128).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from exmc_tpu.particle import particle_filter as jparticle_filter
from exmc_tpu.particle import systematic_resample as jsystematic_resample
from exmc_tpu_torch.particle import particle_filter, pmcmc, smc2, systematic_resample
from exmc_tpu_torch.particle.filter import make_log_marginal_fn
from test_torch_families import one_torch_thread  # noqa: F401 (autouse)

Q, R, T = 0.3, 0.5, 40


def make_data(seed=0, q=Q, r=R, t=T):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.normal(0, q, t))
    return (x + rng.normal(0, r, t)).astype(np.float32)


def kalman_loglik_and_filter(ys, q, r):
    """Exact log p(y_{1:T}) and filtered means for x_1 ~ N(0, q^2),
    x_t ~ N(x_{t-1}, q^2), y_t ~ N(x_t, r^2)."""
    m, p, ll, means = 0.0, 0.0, 0.0, []
    for y in np.asarray(ys, np.float64):
        mp, pp = m, p + q * q
        s = pp + r * r
        ll += -0.5 * (np.log(2 * np.pi * s) + (y - mp) ** 2 / s)
        k = pp / s
        m, p = mp + k * (y - mp), (1 - k) * pp
        means.append(m)
    return ll, np.array(means)


def ssm_fns(q=None, r=None):
    """Model callables; a params dict {"q", "r"} overrides the fixed values."""

    def init_fn(gen, n, params):
        return params.get("q", q) * torch.randn(n, generator=gen)

    def step_fn(gen, x, t, params):
        return x + params.get("q", q) * torch.randn(x.shape, generator=gen)

    def loglik_fn(x, y, t, params):
        rr = torch.as_tensor(params.get("r", r))
        z = (y - x) / rr
        return -0.5 * z * z - torch.log(rr) - 0.5 * np.log(2 * np.pi)

    return init_fn, step_fn, loglik_fn


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_systematic_resample_matches_jax_given_u0():
    rng = np.random.default_rng(0)
    for i in range(8):
        n = int(rng.integers(5, 300))
        log_w = (3.0 * rng.normal(size=n)).astype(np.float32)
        key = jax.random.PRNGKey(i)
        want = np.asarray(jsystematic_resample(key, jnp.asarray(log_w)))
        u0 = np.asarray(jax.random.uniform(key, (), jnp.float32, 0.0, 1.0 / n))
        got = systematic_resample(None, torch.tensor(log_w), u0=torch.tensor(u0))
        np.testing.assert_array_equal(got.numpy(), want)
    # rows of a batch resample independently
    lw = torch.tensor(rng.normal(size=(3, 50)), dtype=torch.float32)
    u = torch.tensor([0.001, 0.01, 0.015])
    rows = systematic_resample(None, lw, u0=u)
    for b in range(3):
        np.testing.assert_array_equal(rows[b].numpy(),
                                      systematic_resample(None, lw[b], u0=u[b]).numpy())


def test_systematic_resample_targets_weights():
    log_w = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4]))
    gen = _gen(0)
    counts = np.zeros(4)
    for _ in range(200):
        counts += np.bincount(systematic_resample(gen, log_w, n=100).numpy(), minlength=4)
    np.testing.assert_allclose(counts / counts.sum(), [0.1, 0.2, 0.3, 0.4], atol=0.01)


def test_particle_filter_lockstep_with_jax_draws():
    ys = make_data(seed=3)
    n = 64
    key = jax.random.PRNGKey(5)

    def j_init(k, n_, params):
        return Q * jax.random.normal(k, (n_,))

    def j_step(k, x, t, params):
        return x + Q * jax.random.normal(k, x.shape)

    def j_ll(x, y, t, params):
        z = (y - x) / R
        return -0.5 * z * z - jnp.log(R) - 0.5 * jnp.log(2 * jnp.pi)

    want = jparticle_filter(j_init, j_step, j_ll, jnp.asarray(ys), n, key, {})
    # the filter's key discipline: key, init = split(key); per step
    # key, rkey, skey = split(key, 3)
    k, ik = jax.random.split(key)
    z0 = np.asarray(jax.random.normal(ik, (n,)))
    noise, offsets = [], []
    for _ in range(T):
        k, rk, sk = jax.random.split(k, 3)
        noise.append(np.asarray(jax.random.normal(sk, (n,))))
        offsets.append(float(jax.random.uniform(rk, (), jnp.float32, 0.0, 1.0 / n)))

    def t_init(gen, n_, params):
        return Q * torch.tensor(z0)

    def t_step(gen, x, t, params):
        return x + Q * torch.tensor(noise[t])

    got = particle_filter(t_init, t_step, ssm_fns(Q, R)[2], ys, n, _gen(0), {},
                          resample_u=np.array(offsets, np.float32))
    assert abs(float(got["log_marginal"]) - float(want["log_marginal"])) < 1e-3
    np.testing.assert_allclose(got["filtered_means"].numpy(), np.asarray(want["filtered_means"]),
                               atol=1e-4)
    np.testing.assert_allclose(got["ess"].numpy(), np.asarray(want["ess"]), atol=1e-4)
    assert (np.asarray(want["ess"]) < 0.5).any()      # the lockstep resampled


def test_pf_log_marginal_matches_kalman():
    ys = make_data()
    exact, _ = kalman_loglik_and_filter(ys, Q, R)
    init_fn, step_fn, loglik_fn = ssm_fns(Q, R)
    gen = _gen(0)
    lls = np.array([float(particle_filter(init_fn, step_fn, loglik_fn, ys, 512, gen, {})
                          ["log_marginal"]) for _ in range(30)])
    assert abs(np.mean(lls) - exact) < 0.5, (np.mean(lls), exact)
    assert np.std(lls) < 0.5


def test_pf_filtered_means_match_kalman():
    ys = make_data()
    _, exact_means = kalman_loglik_and_filter(ys, Q, R)
    out = particle_filter(*ssm_fns(Q, R), ys, 4096, _gen(1), {})
    assert np.max(np.abs(out["filtered_means"].numpy() - exact_means)) < 0.15
    assert out["ess"].numpy().min() > 0.05


def quad_posterior_r(ys, lo=0.2, hi=1.2, n=81):
    grid = np.linspace(lo, hi, n)
    ll = np.array([kalman_loglik_and_filter(ys, Q, float(r))[0] for r in grid])
    w = np.exp(ll - ll.max())
    w /= np.trapezoid(w, grid)
    mean = np.trapezoid(w * grid, grid)
    return mean, np.sqrt(np.trapezoid(w * (grid - mean) ** 2, grid)), grid, ll


def _r_model():
    init_fn, step_fn, loglik_fn = ssm_fns(q=Q)

    def wrap_loglik(x, y, t, params):
        return loglik_fn(x, y, t, {"r": params[..., 0]})

    def wrap_step(gen, x, t, params):
        return step_fn(gen, x, t, {})

    def wrap_init(gen, n, params):
        return init_fn(gen, n, {})

    def log_prior(theta):
        r = theta[..., 0]
        return torch.where((r > 0.2) & (r < 1.2), 0.0, -torch.inf)

    return wrap_init, wrap_step, wrap_loglik, log_prior


def test_pmcmc_posterior_matches_kalman_quadrature():
    ys = make_data()
    exact_mean, exact_sd, _, _ = quad_posterior_r(ys)
    wrap_init, wrap_step, wrap_loglik, log_prior = _r_model()
    lm = make_log_marginal_fn(wrap_init, wrap_step, wrap_loglik, ys, 256)
    thetas, acc = pmcmc(lm, log_prior, torch.tensor([0.6]), 600, _gen(0), step_scale=0.08,
                        num_chains=4)
    assert thetas.shape == (4, 600, 1) and acc.shape == (4,)
    draws = thetas[:, 200:, 0].numpy().reshape(-1)
    assert 0.05 < float(acc.mean()) < 0.9
    assert abs(draws.mean() - exact_mean) < 2.5 * exact_sd / np.sqrt(20)
    assert 0.5 < draws.std() / exact_sd < 2.0


def test_smc2_posterior_and_evidence():
    ys = make_data()
    exact_mean, exact_sd, grid, lls = quad_posterior_r(ys)
    wrap_init, wrap_step, wrap_loglik, log_prior = _r_model()

    def prior_sample(gen, n):
        return 0.2 + torch.rand(n, 1, generator=gen)

    out = smc2(wrap_init, wrap_step, wrap_loglik, prior_sample, log_prior, ys,
               n_theta=128, n_x=128, generator=_gen(0))
    w = torch.softmax(out["log_weights"], 0).numpy()
    th = out["thetas"][:, 0].numpy()
    post_mean = float((w * th).sum())
    post_sd = float(np.sqrt((w * (th - post_mean) ** 2).sum()))
    assert abs(post_mean - exact_mean) < 3.0 * exact_sd / np.sqrt(10)
    assert 0.4 < post_sd / exact_sd < 2.5
    assert int(out["rejuvenations"]) >= 1
    assert out["host_syncs"] == T
    exact_log_ev = np.log(np.trapezoid(np.exp(lls - lls.max()), grid) / (1.2 - 0.2)) + lls.max()
    assert abs(float(out["log_evidence"]) - exact_log_ev) < 1.5
