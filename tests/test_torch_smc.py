"""SMC in the port against the JAX package on the CPU:

* the first stage of a ``tempering="full"`` run from JAX's start with
  JAX's draws (the key discipline of ``exmc_tpu/smc.py``): the bisected
  increment (1e-5 relative), the systematic resample indices (exact),
  the mutated particles and the stage's accept rate (1e-5) against
  JAX's ``max_stages=1`` run;
* ``_systematic_resample`` against JAX's on the same weights and
  uniform, an index past the end included;
* the conjugate posterior and the closed-form evidence of
  ``tempering="likelihood"`` (``tests/test_vi_smc.py``: evidence within
  0.3, posterior mean within 0.1), a ``CompiledModel`` input, the
  full-logp run without an evidence, the argument check;
* the ``max_stages`` warning.
"""

import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu import smc as jsmc
from exmc_tpu_torch import smc as tsmc
from exmc_tpu_torch.compiler import compile_logp

RTOL = 1e-5


def conjugate(pkg, n=30, seed=5, sd0=3.0):
    y = np.random.default_rng(seed).normal(2.0, 1.0, n)
    B, D = pkg.Builder, pkg.dists
    ir = B.rv(B.new_ir(), "mu", D.Normal, {"mu": 0.0, "sigma": sd0})
    ir = B.rv(ir, "y", D.Normal, {"mu": "mu", "sigma": 1.0})
    ir = B.obs(ir, "y_obs", "y", y)
    cov = np.eye(n) + sd0 ** 2 * np.ones((n, n))
    _, logdet = np.linalg.slogdet(cov)
    log_z = -0.5 * (n * np.log(2 * np.pi) + logdet + y @ np.linalg.solve(cov, y))
    return ir, y.sum() / (1.0 / sd0 ** 2 + n), log_z


def two_d(pkg):
    """mu and a positive sigma: a stage with a transform."""
    y = np.random.default_rng(1).normal(1.0, 2.0, 20)
    B, D = pkg.Builder, pkg.dists
    ir = B.rv(B.new_ir(), "mu", D.Normal, {"mu": 0.0, "sigma": 3.0})
    ir = B.rv(ir, "sigma", D.HalfNormal, {"sigma": 3.0})
    ir = B.rv(ir, "y", D.Normal, {"mu": "mu", "sigma": "sigma"})
    return B.obs(ir, "y_obs", "y", y)


@pytest.mark.parametrize("steps", [1, 3])
def test_first_stage_lockstep_with_jax(steps):
    n, seed = 256, 4
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, info = jsmc.smc_sample(two_d(exmc_tpu), num_particles=n, seed=seed,
                                  num_mh_steps=steps, max_stages=1)
    key = jax.random.PRNGKey(seed)
    key, init_key = jax.random.split(key)
    model = compile_logp(two_d(exmc_tpu_torch), device="cpu")
    p0 = torch.as_tensor(np.asarray(jax.random.normal(init_key, (n, model.size),
                                                      jnp.float32)))
    lts = model.logp(p0)
    delta = min(float(tsmc._find_delta(lts, 0.0, 0.5 * n)), 1.0)
    np.testing.assert_allclose(delta, info["betas"][1], rtol=RTOL)
    _, rkey, mkey = jax.random.split(key, 3)
    log_w = delta * lts.numpy().astype(np.float64)
    idx = tsmc._systematic_resample(
        torch.as_tensor(np.asarray(jax.random.uniform(rkey))),
        torch.as_tensor(log_w, dtype=torch.float32), n)
    want_idx = jsmc._systematic_resample(rkey, jnp.asarray(log_w), n)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    zs, us = [], []
    for k in jax.random.split(mkey, steps):
        pk, ak = jax.random.split(k)
        zs.append(torch.as_tensor(np.asarray(jax.random.normal(pk, (n, model.size)))))
        us.append(torch.as_tensor(np.asarray(jax.random.uniform(ak, (n,)))))
    parts, _, _, acc = tsmc._mutate(model.logp, None, p0[idx], torch.zeros(n), lts[idx],
                                    torch.tensor(delta), zs, us)
    np.testing.assert_allclose(parts.numpy(), info["particles_unconstrained"][0],
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(float(acc), info["accept_rates"][0], rtol=RTOL)


def test_systematic_resample_equals_jax():
    rng = np.random.default_rng(3)
    for n in (5, 64, 1000):
        log_w = rng.normal(0, 3, n).astype(np.float32)
        for u in (0.0, 0.37, 1.0 - 2 ** -24):
            got = tsmc._systematic_resample(torch.tensor(u), torch.as_tensor(log_w), n)
            # JAX's uniform draw replaced by u: the same formula
            w = jnp.exp(log_w - jax.scipy.special.logsumexp(log_w))
            want = jnp.searchsorted(jnp.cumsum(w), (u + jnp.arange(n)) / n)
            np.testing.assert_array_equal(got.numpy(), np.minimum(np.asarray(want), n - 1))


def test_likelihood_tempering_conjugate_evidence():
    ir, post_mean, log_z = conjugate(exmc_tpu_torch)
    trace, info = tsmc.smc_sample(ir, num_particles=2000, seed=1, tempering="likelihood",
                                  device="cpu")
    assert info["converged"] and info["betas"][-1] == 1.0
    assert info["log_evidence"] == pytest.approx(log_z, abs=0.3)
    assert trace["mu"][0].mean() == pytest.approx(post_mean, abs=0.1)
    _, info_cm = tsmc.smc_sample(compile_logp(ir, device="cpu"), num_particles=1500,
                                 seed=2, tempering="likelihood")
    assert info_cm["converged"]
    assert info_cm["log_evidence"] == pytest.approx(log_z, abs=0.5)
    trace, info_full = tsmc.smc_sample(ir, num_particles=1500, seed=0, device="cpu")
    assert "log_evidence" not in info_full and info_full["betas"][-1] == 1.0
    assert abs(float(trace["mu"].mean()) - post_mean) < 0.15
    assert info_full["accept_rates"].shape == (info_full["num_stages"],)
    with pytest.raises(ValueError, match="tempering"):
        tsmc.smc_sample(ir, tempering="prior", device="cpu")


def test_max_stages_warns_and_gives_no_evidence():
    ir, _, _ = conjugate(exmc_tpu_torch)
    with pytest.warns(UserWarning, match="max_stages"):
        _, info = tsmc.smc_sample(ir, num_particles=200, max_stages=1,
                                  tempering="likelihood", device="cpu")
    assert not info["converged"] and info["log_evidence"] is None
    assert info["num_stages"] == 1 and info["betas"][-1] < 1.0
