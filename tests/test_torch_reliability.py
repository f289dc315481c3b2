"""The Weibull reliability model in the port against the JAX package on
the CPU: ``simulate_data`` equal to JAX's exactly (the same numpy
generator), ``build``'s dimension, its log-density and gradient at
seeded points (1e-5 relative; the gradient 1e-4 of its largest entry),
and Pathfinder on it from JAX's draws equal to JAX's fit (1e-3
relative: the fixed-step path runs out to |x| ~ 1e5 on three
coordinates and carries f32 rounding with it). The diag fit is far off
on most seeds in both packages, so the reliability task of
``benchmarks/post.py`` reports it ungated."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from exmc_tpu import pathfinder_fit as jpathfinder
from exmc_tpu.benchmarks import reliability as jrel
from exmc_tpu.compiler import compile_logp as jcompile
from exmc_tpu_torch import pathfinder_fit as tpathfinder
from exmc_tpu_torch.benchmarks import reliability as trel
from exmc_tpu_torch.compiler import compile_logp as tcompile

from test_torch_vi import pathfinder_draws


@pytest.mark.parametrize("n_types,n_per_type,seed", [(20, 25, 0), (8, 30, 3)])
def test_simulate_data_equals_jax(n_types, n_per_type, seed):
    jd, jt = jrel.simulate_data(n_types=n_types, n_per_type=n_per_type, seed=seed)
    td, tt = trel.simulate_data(n_types=n_types, n_per_type=n_per_type, seed=seed)
    assert td.dtype == jd.dtype and td.shape == jd.shape == (n_types * n_per_type, 3)
    np.testing.assert_array_equal(td, jd)
    for k in ("log_k", "log_l"):
        np.testing.assert_array_equal(tt[k], jt[k])


def test_build_logp_and_grad_equal_jax():
    data, _ = jrel.simulate_data(n_types=20, n_per_type=25)
    jm = jcompile(jrel.build(data, n_types=20))
    tm = tcompile(trel.build(data, n_types=20), device="cpu")
    assert tm.size == jm.size == 44
    x = (0.3 * np.random.default_rng(0).normal(size=(6, 44))).astype(np.float32)
    lp, g = tm.value_and_grad(torch.as_tensor(x))
    for i in range(6):
        want, want_g = jax.value_and_grad(lambda z: jm.logp(z, jm.data))(jnp.asarray(x[i]))
        np.testing.assert_allclose(float(lp[i]), float(want), rtol=1e-5)
        np.testing.assert_allclose(g[i].numpy(), np.asarray(want_g),
                                   atol=1e-4 * float(np.abs(want_g).max()))


def test_pathfinder_from_jax_draws_equals_jax():
    n_types, iters = 4, 50
    data, _ = jrel.simulate_data(n_types=n_types, n_per_type=25)
    want = jpathfinder(jrel.build(data, n_types), num_iters=iters, data=data, seed=0)
    got = tpathfinder(trel.build(data, n_types), num_iters=iters, data=data, device="cpu",
                      **pathfinder_draws(0, iters, 20, 1000, 4 + 2 * n_types, False))
    assert got["best_iter"] == want["best_iter"]
    np.testing.assert_allclose(got["mu"], np.asarray(want["mu"]), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(float(got["draws"]["log_l_mean"].mean()),
                               float(np.asarray(want["draws"]["log_l_mean"]).mean()),
                               rtol=1e-3)
