"""``exmc_tpu_torch.apps.physics`` against the JAX package's
``exmc_tpu.apps.physics`` on the same numpy inputs: the Jacobi heat
solve and its gradient, the level-set fields, the sensor reads, and the
inverse model's log-density and gradient with a forward written for one
field (example 05's, which reads the fixed bottom boundary, and one that
reads interior cells); then ``tests/test_apps.py``'s physics tests on the port and the
``apps:physics`` card task at a small size (its NUTS run for plumbing
only: example 05's tree saturates)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from exmc_tpu.apps import physics as jphysics
from exmc_tpu.compiler import compile_logp as jcompile
from exmc_tpu_torch.apps import physics
from exmc_tpu_torch.benchmarks import apps
from exmc_tpu_torch.compiler import compile_logp
from test_torch_families import one_torch_thread  # noqa: F401 (autouse)

ATOL_SOLVE = 1e-5
REL_VALUE = 1e-5
REL_GRAD = 1e-4


@pytest.mark.parametrize("n,iterations", [(16, 500), (12, 20), (40, 60)])
def test_solve_matches_jax(n, iterations):
    kappa = np.random.default_rng(n).uniform(0.5, 2.0, size=(n, n)).astype(np.float32)
    want = np.asarray(jphysics.heat2d_solve(jnp.asarray(kappa), iterations=iterations,
                                            bc_top=1.0, bc_bottom=0.2))
    got = physics.heat2d_solve(torch.as_tensor(kappa), iterations=iterations, bc_top=1.0,
                               bc_bottom=0.2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_SOLVE)


def test_solve_gradient_matches_jax():
    kappa = np.random.default_rng(1).uniform(0.5, 2.0, size=(12, 12)).astype(np.float32)
    pos = [(8, 8), (3, 4), (11, 0)]

    def jloss(k):
        return jnp.sum(jphysics.read_sensors(jphysics.heat2d_solve(k, iterations=20), pos))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(kappa)))
    k = torch.as_tensor(kappa).requires_grad_()
    physics.read_sensors(physics.heat2d_solve(k, iterations=20), pos).sum().backward()
    got = k.grad.numpy()
    assert np.abs(got - want).max() <= REL_GRAD * np.abs(want).max()


def test_solve_on_a_batch_and_under_vmap_equals_one_field_at_a_time():
    kappa = torch.as_tensor(np.random.default_rng(2).uniform(0.5, 2.0, size=(3, 8, 9)),
                            dtype=torch.float32)
    one = torch.stack([physics.heat2d_solve(k, iterations=15) for k in kappa])
    torch.testing.assert_close(physics.heat2d_solve(kappa, iterations=15), one,
                               rtol=0, atol=0)
    torch.testing.assert_close(
        torch.func.vmap(lambda k: physics.heat2d_solve(k, iterations=15))(kappa), one,
        rtol=0, atol=0)


def test_level_set_fields_and_sensors_match_jax():
    phi = np.random.default_rng(3).normal(0, 2, size=(7, 5)).astype(np.float32)
    for eps in (1.0, 0.3):
        np.testing.assert_allclose(
            physics.smooth_heaviside(torch.as_tensor(phi), eps).numpy(),
            np.asarray(jphysics.smooth_heaviside(jnp.asarray(phi), eps)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        physics.material_field(torch.as_tensor(phi), 2.0, 0.5).numpy(),
        np.asarray(jphysics.material_field(jnp.asarray(phi), 2.0, 0.5)), rtol=1e-6, atol=1e-7)
    t = np.random.default_rng(4).normal(size=(7, 5)).astype(np.float32)
    pos = [(0, 0), (6, 4), (3, 2), (3, 2)]
    for p in ("bottom_row", pos):
        np.testing.assert_array_equal(physics.read_sensors(torch.as_tensor(t), p).numpy(),
                                      np.asarray(jphysics.read_sensors(jnp.asarray(t), p)))
    batch = torch.as_tensor(np.stack([t, 2 * t]))
    np.testing.assert_array_equal(physics.read_sensors(batch, pos)[1].numpy(),
                                  2 * physics.read_sensors(torch.as_tensor(t), pos).numpy())


def test_laplacian_prior_matches_jax_per_chain():
    ny, nx = 5, 6
    x = np.random.default_rng(5).normal(size=(4, ny * nx)).astype(np.float32)
    got = physics.laplacian_prior_logpdf(ny, nx, 1.7)(torch.as_tensor(x), {})
    want = [float(jphysics.laplacian_prior_logpdf(ny, nx, 1.7)(jnp.asarray(r), {})) for r in x]
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), want, rtol=REL_VALUE)


def _forwards(iterations, sensors="bottom_row"):
    def jforward(phi):
        kappa = jphysics.material_field(phi, 2.0, 0.5)
        return jphysics.read_sensors(jphysics.heat2d_solve(kappa, iterations=iterations),
                                     sensors)

    return jforward, apps.example05_forward(iterations, sensors)


@pytest.mark.parametrize("sensors", ["bottom_row", "interior"])
def test_inverse_model_matches_jax_compile_logp(sensors):
    ny = nx = 6
    if sensors == "interior":
        sensors = apps.interior_sensors(ny, nx)
    jforward, forward = _forwards(10, sensors)
    data = np.random.default_rng(6).normal(0.3, 0.1, nx).astype(np.float32)
    jm = jcompile(jphysics.build_inverse_model(jforward, data, ny=ny, nx=nx,
                                               noise_sigma=0.05, lam=1.0))
    tm = compile_logp(physics.build_inverse_model(forward, data, ny=ny, nx=nx,
                                                  noise_sigma=0.05, lam=1.0), device="cpu")
    assert tm.size == jm.size == ny * nx
    x = np.random.default_rng(7).normal(size=(8, ny * nx)).astype(np.float32)
    lp, g = tm.value_and_grad(torch.as_tensor(x))
    jv, jg = (np.asarray(a) for a in jax.jit(jax.vmap(jm.value_and_grad, (0, None)))(
        jnp.asarray(x), jnp.asarray(data)))
    for i in range(8):
        assert abs(float(lp[i]) - jv[i]) <= REL_VALUE * abs(jv[i])
        assert np.abs(g[i].numpy() - jg[i]).max() <= REL_GRAD * np.abs(jg[i]).max()
    # the bottom row is Dirichlet boundary, held at bc_bottom: example 05's
    # likelihood is constant in phi and only the prior has a gradient
    prior = physics.laplacian_prior_logpdf(ny, nx, 1.0)
    x_req = torch.as_tensor(x).requires_grad_()
    g_prior, = torch.autograd.grad(prior(x_req, {}).sum(), x_req)
    lik_grad = (g - g_prior).abs().max().item()
    assert lik_grad == 0.0 if sensors == "bottom_row" else lik_grad > 1e-3


# ---- tests/test_apps.py's physics tests, on the port ----

def test_heat2d_uniform_kappa_linear_profile():
    t = physics.heat2d_solve(torch.ones(16, 16), iterations=500)
    expected = 1.0 * (1 - np.arange(16) / 15.0)
    np.testing.assert_allclose(t[:, 8].numpy(), expected, atol=0.01)


def test_heat2d_differentiable():
    k = (torch.ones(12, 12) * 1.5).requires_grad_()
    physics.read_sensors(physics.heat2d_solve(k, iterations=20), [(8, 8)]).sum().backward()
    assert torch.isfinite(k.grad).all()


def test_smooth_heaviside():
    h = physics.smooth_heaviside(torch.tensor([-10.0, 0.0, 10.0]), eps=1.0)
    np.testing.assert_allclose(h.numpy(), [0.0, 0.5, 1.0], atol=1e-4)


def test_material_field():
    kappa = physics.material_field(torch.tensor([-10.0, 10.0]), 2.0, 0.5)
    np.testing.assert_allclose(kappa.numpy(), [0.5, 2.0], atol=1e-3)


def test_level_set_inverse_model_compiles():
    ny = nx = 6
    data = np.zeros(nx, np.float32)
    ir = physics.build_inverse_model(apps.example05_forward(10), data, ny=ny, nx=nx)
    m = compile_logp(ir, device="cpu")
    assert m.size == ny * nx
    v, g = m.value_and_grad(torch.zeros(1, ny * nx))
    assert torch.isfinite(v).all() and torch.isfinite(g).all()


def test_physics_task_small():
    cfg = dict(apps.PHYSICS, ny=6, nx=6, iterations=10, chains=4, warmup=5, draws=5,
               max_tree_depth=3)
    res = apps.check_physics("cpu", cfg)
    assert res["compile_check"] == {"value_rel_err": 0.0, "grad_rel_err": 0.0}
    assert res["compile_check_interior"] == {"value_rel_err": 0.0, "grad_rel_err": 0.0}
    assert res["host_syncs"] > 0 and 0.0 <= res["max_depth_share"] <= 1.0
    assert np.isfinite(res["step_size"]) and res["true_void"] == pytest.approx(4 / 36)
    phi_true, noisy = apps.example05_data(6, 6, 10)
    want = np.asarray(_forwards(10)[0](jnp.asarray(phi_true)))
    np.testing.assert_allclose(noisy - np.random.default_rng(0).normal(
        0, 0.01, 6).astype(np.float32), want, atol=1e-6)


def test_physics_task_reports_gates_it_misses(monkeypatch):
    # a JAX range no run can meet: both gates fail, and the task says so
    monkeypatch.setattr(apps, "PHYSICS_JAX", {"max_depth_share": (2.0, 3.0),
                                             "step_size": (1e6, 2e6)})
    cfg = dict(apps.PHYSICS, ny=5, nx=5, iterations=3, chains=2, warmup=2, draws=2,
               max_tree_depth=2)
    res = apps.check_physics("cpu", cfg)
    assert not res["ok"]
    assert [f.split(" ")[0] for f in res["failures"]] == ["max-depth", "step"]
