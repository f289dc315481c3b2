"""``exmc_tpu_torch.marginal`` against the JAX package and exact oracles,
and the port's float64 path (``config.x64``).

* The tridiagonal primitives (``_thomas_factor``/``_thomas_solve``/
  ``_takahashi_diag``) and the banded ones (``_banded_*``) at T <= 256:
  against JAX's on the same f32 inputs (the port's log-depth scans
  combine in another order than XLA's blocked scans: f32 relative
  1e-5 at T <= 7, 5e-3 at T = 256) and, in f64, against a dense numpy
  solve (1e-9 relative).
* Each marginal's logZ, s_hat, var_hat and gradient against JAX's
  (f32, rtol 1e-4 / 2e-3 for gradients) and, in f64, against the dense
  Gaussian identity.
* The counterparts of ``tests/test_marginal.py``'s exactness, scan and
  implicit-gradient tests (its INLA and NUTS tests are in
  ``tests/test_torch_marginal_runs.py``), at the JAX tests' sizes and
  tolerances; the implicit (``torch.autograd.Function``) gradient
  against the unrolled one.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from exmc_tpu import marginal as JM
from exmc_tpu.benchmarks.suite import sv_model as jsv_model
from exmc_tpu_torch import config
from exmc_tpu_torch import marginal as TM
from exmc_tpu_torch.benchmarks.gold_models import kalman_smoother_grw
from exmc_tpu_torch.marginal import make_grw_marginal
from test_torch_families import one_torch_thread  # noqa: F401 (autouse)


def _sv_returns(t):
    return np.asarray(jsv_model(t=t).nodes["r_obs"].op[2])


def _tridiag(t, seed=0, sigma=0.02):
    rng = np.random.default_rng(seed)
    w = np.abs(rng.normal(0.5, 0.2, t))
    a = np.full(t, 2.0) / sigma ** 2 + w
    a[-1] = 1.0 / sigma ** 2 + w[-1]
    return a, -1.0 / sigma ** 2, rng.normal(size=t)


def _dense(a, b):
    t = len(a)
    return np.diag(a) + np.diag(np.full(t - 1, b), 1) + np.diag(np.full(t - 1, b), -1)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,tol", [(2, 1e-6), (7, 1e-5), (64, 1e-3), (256, 5e-3)])
def test_tridiagonal_primitives_match_jax(t, tol):
    a, b, rhs = _tridiag(t)
    a32, rhs32 = a.astype(np.float32), rhs.astype(np.float32)
    dj, lj = JM._thomas_factor(jnp.asarray(a32), jnp.float32(b))
    dt, lt = TM._thomas_factor(torch.tensor(a32), torch.tensor([b], dtype=torch.float32))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=tol)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=tol)
    xj = np.asarray(JM._thomas_solve(dj, lj, jnp.asarray(rhs32)))
    xt = TM._thomas_solve(dt, lt, torch.tensor(rhs32)).numpy()
    assert np.abs(xt - xj).max() / np.abs(xj).max() < tol
    np.testing.assert_allclose(TM._takahashi_diag(dt, lt).numpy(),
                               np.asarray(JM._takahashi_diag(dj, lj)), rtol=tol)


@pytest.mark.parametrize("t", [1, 2, 7, 256])
def test_tridiagonal_primitives_f64_match_dense_solve(t):
    a, b, rhs = _tridiag(t, seed=1)
    with config.x64():
        d, ell = TM._thomas_factor(torch.tensor(a), torch.tensor([b]))
        assert d.dtype == torch.float64 and d.shape == (t,) and ell.shape == (t - 1,)
        if t == 1:
            return
        x = TM._thomas_solve(d, ell, torch.tensor(rhs)).numpy()
        diag = TM._takahashi_diag(d, ell).numpy()
    mat = _dense(a, b)
    x_ref = np.linalg.solve(mat, rhs)
    assert np.abs(x - x_ref).max() / np.abs(x_ref).max() < 1e-9
    np.testing.assert_allclose(diag, np.diag(np.linalg.inv(mat)), rtol=1e-9)
    # the factors reproduce the matrix: L D L'
    L = np.eye(t) + np.diag(ell.numpy(), -1)
    np.testing.assert_allclose(L @ np.diag(d.numpy()) @ L.T, mat, rtol=1e-9, atol=1e-6)


def _banded_q(t, p, seed=2):
    """An SPD banded precision (p+1, t) from a random AR whitener."""
    rng = np.random.default_rng(seed)
    phis = np.array([0.5, 0.3, -0.1][:p])
    c, _ = TM._arp_whitener_bands(torch.tensor(phis), torch.tensor(0.7), t)
    qb = TM._bands_from_whitener(c, p).numpy()
    qb[0] += np.abs(rng.normal(0.5, 0.2, t))
    return qb, rng.normal(size=t)


@pytest.mark.parametrize("p", [2, 3])
def test_banded_primitives_match_jax_and_dense(p):
    t = 40
    with config.x64():
        qb, rhs = _banded_q(t, p)
        d, l = TM._banded_ldl(torch.tensor(qb), p)
        x = TM._banded_solve(d, l, torch.tensor(rhs)).numpy()
        diag = TM._banded_takahashi_diag(d, l).numpy()
    mat = np.diag(qb[0])
    for j in range(1, p + 1):
        mat += np.diag(qb[j, j:], -j) + np.diag(qb[j, j:], j)
    np.testing.assert_allclose(x, np.linalg.solve(mat, rhs), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(diag, np.diag(np.linalg.inv(mat)), rtol=1e-9)
    qb32, rhs32 = qb.astype(np.float32), rhs.astype(np.float32)
    dj, lj = JM._banded_ldl(jnp.asarray(qb32), p)
    dt, lt = TM._banded_ldl(torch.tensor(qb32), p)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(TM._banded_solve(dt, lt, torch.tensor(rhs32)).numpy(),
                               np.asarray(JM._banded_solve(dj, lj, jnp.asarray(rhs32))),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(TM._banded_takahashi_diag(dt, lt).numpy(),
                               np.asarray(JM._banded_takahashi_diag(dj, lj)), rtol=1e-5)


# ---------------------------------------------------------------------------
# marginals against the JAX package
# ---------------------------------------------------------------------------

def test_sv_marginal_value_and_grad_match_jax():
    r = _sv_returns(120)
    x0 = np.array([0.08, 12.0], np.float32)
    mj = JM.make_grw_marginal(JM._sv_loglik(r), len(r), newton_iters=12)
    vj, gj = jax.jit(jax.value_and_grad(lambda x: mj(x[0], {"nu": x[1]})[0]))(
        jnp.asarray(x0))
    _, sj, varj = jax.jit(lambda x: mj(x[0], {"nu": x[1]}))(jnp.asarray(x0))
    mt = TM.make_grw_marginal(TM._sv_loglik(r), len(r), newton_iters=12)
    x = torch.tensor(x0, requires_grad=True)
    vt, st, vart = mt(x[0], {"nu": x[1]})
    gt, = torch.autograd.grad(vt, x)
    assert abs(float(vt.detach()) - float(vj)) < 1e-4 * abs(float(vj))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=2e-3)
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(sj), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(vart.detach().numpy(), np.asarray(varj), rtol=1e-3)


def test_ar1_and_arp_marginals_match_jax():
    rng = np.random.default_rng(5)
    T = 64
    y = rng.normal(size=T).astype(np.float32)
    yj, yt = jnp.asarray(y), torch.tensor(y)

    def jll(s, th):
        return -0.5 * ((yj - s) / 0.5) ** 2

    def tll(s, th):
        return -0.5 * ((yt - s) / 0.5) ** 2

    vj, gj = jax.jit(jax.value_and_grad(
        lambda x: JM.make_ar1_marginal(jll, T, newton_iters=6)(x[0], x[1], {})[0]))(
        jnp.asarray([0.3, 0.7]))
    x = torch.tensor([0.3, 0.7], requires_grad=True)
    vt = TM.make_ar1_marginal(tll, T, newton_iters=6)(x[0], x[1], {})[0]
    gt, = torch.autograd.grad(vt, x)
    assert abs(float(vt.detach()) - float(vj)) < 1e-4 * abs(float(vj))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=2e-3)

    vj, gj = jax.jit(jax.value_and_grad(
        lambda x: JM.make_arp_marginal(jll, T, 2, newton_iters=6)(x[0], x[1:], {})[0]))(
        jnp.asarray([0.4, 0.5, 0.2]))
    x = torch.tensor([0.4, 0.5, 0.2], requires_grad=True)
    vt = TM.make_arp_marginal(tll, T, 2, newton_iters=6)(x[0], x[1:], {})[0]
    gt, = torch.autograd.grad(vt, x)
    assert abs(float(vt.detach()) - float(vj)) < 1e-4 * abs(float(vj))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=2e-3)


def test_batched_points_equal_one_at_a_time():
    r = _sv_returns(80)
    m = TM.make_grw_marginal(TM._sv_loglik(r), len(r), newton_iters=8)
    sig, nu = torch.tensor([0.08, 0.05, 0.2]), torch.tensor([12.0, 4.0, 40.0])
    lz, sh, vh = m(sig, {"nu": nu})
    assert lz.shape == (3,) and sh.shape == (3, 80) and vh.shape == (3, 80)
    for i in range(3):
        l1, s1, v1 = m(sig[i], {"nu": nu[i]})
        np.testing.assert_allclose(float(lz[i]), float(l1), rtol=1e-6)
        np.testing.assert_allclose(sh[i].numpy(), s1.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# tests/test_marginal.py's eight tests on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x64", [False, True])
def test_gaussian_likelihood_exact(x64):
    rng = np.random.default_rng(0)
    T, q, r = 200, 0.3, 0.7
    y = np.cumsum(rng.normal(0, q, T)) + rng.normal(0, r, T)
    with config.x64(x64):
        yt = torch.as_tensor(y, dtype=config.default_dtype())

        def loglik(s, theta):
            return -0.5 * ((yt - s) / r) ** 2 - np.log(r) - 0.5 * np.log(2 * np.pi)

        logZ, s_hat, var_hat = make_grw_marginal(loglik, T)(torch.tensor(q), {})
    D = np.eye(T) - np.diag(np.ones(T - 1), -1)
    Sig = np.linalg.inv(D.T @ D / q ** 2) + np.eye(T) * r ** 2
    exact = -0.5 * (np.linalg.slogdet(2 * np.pi * Sig)[1] + y @ np.linalg.solve(Sig, y))
    m_kal, sd_kal = kalman_smoother_grw(y, q, r)
    tol = (1e-8, 1e-8) if x64 else (1e-3, 1e-4)
    assert abs(float(logZ) - exact) < tol[0] * abs(exact)
    np.testing.assert_allclose(s_hat.numpy(), m_kal, atol=tol[1])
    np.testing.assert_allclose(np.sqrt(var_hat.numpy()), sd_kal, atol=tol[1])


@pytest.mark.parametrize("t,tol", [(1, 1e-6), (2, 1e-6), (7, 1e-5), (500, 4e-3),
                                   (5000, 2e-2)])
def test_associative_tridiagonal_matches_sequential(t, tol):
    """The log-depth scans against the sequential recurrences (numpy
    loops in f32), at the JAX test's sizes and tolerances."""
    a, b, rhs = _tridiag(t, seed=0)
    a, b, rhs = a.astype(np.float32), np.float32(b), rhs.astype(np.float32)
    d1 = np.empty(t, np.float32)
    d1[0] = a[0]
    for i in range(1, t):
        d1[i] = a[i] - b * b / d1[i - 1]
    l1 = b / d1[:-1]
    d2, l2 = TM._thomas_factor(torch.tensor(a), torch.tensor([b]))
    assert np.max(np.abs(d1 - d2.numpy()) / d1) < tol
    if t == 1:
        assert d2.shape == (1,) and l2.shape == (0,)
        return
    y = np.empty(t, np.float32)
    y[0] = rhs[0]
    for i in range(1, t):
        y[i] = rhs[i] - l1[i - 1] * y[i - 1]
    z = y / d1
    x1 = np.empty(t, np.float32)
    x1[-1] = z[-1]
    for i in range(t - 2, -1, -1):
        x1[i] = z[i] - l1[i] * x1[i + 1]
    s1 = np.empty(t, np.float32)
    s1[-1] = 1.0 / d1[-1]
    for i in range(t - 2, -1, -1):
        s1[i] = 1.0 / d1[i] + l1[i] * l1[i] * s1[i + 1]
    x2 = TM._thomas_solve(d2, l2, torch.tensor(rhs)).numpy()
    assert np.max(np.abs(x1 - x2)) / (np.abs(x1).max() + 1e-30) < tol
    s2 = TM._takahashi_diag(d2, l2).numpy()
    assert np.max(np.abs(s1 - s2) / s1) < tol
    x_ref = np.linalg.solve(_dense(a.astype(np.float64), float(b)), rhs.astype(np.float64))
    assert np.abs(x2 - x_ref).max() / (np.abs(x_ref).max() + 1e-30) < 10 * tol


def test_implicit_diff_matches_unrolled_gradient():
    r = _sv_returns(200)

    def vg(implicit):
        m = TM.make_grw_marginal(TM._sv_loglik(r), len(r), newton_iters=15,
                                 implicit_diff=implicit)
        x = torch.tensor([0.08, 12.0], requires_grad=True)
        v = m(x[0], {"nu": x[1]})[0]
        return v, torch.autograd.grad(v, x)[0]

    v_u, g_u = vg(False)
    v_i, g_i = vg(True)
    assert float(v_u.detach()) == float(v_i.detach())      # the forward is the same computation
    np.testing.assert_allclose(g_i.numpy(), g_u.numpy(), rtol=2e-3, atol=1e-4)
