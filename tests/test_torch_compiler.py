"""The compiler features this slice adds to the port, held against the
JAX package's compiled models on the same numpy inputs: the det ops
dot/getitem/smul/cumsum/stack/concat, keyed data and the "__base"
convention, weighted/masked/reduced observations, a measurable lift of a
sampled matrix, ``partial_logp``, ``compile_pointwise``, and
``interop.ir_from_reference`` over every distribution, transform and obs
form it carries (and the callables it refuses).

Tolerance: float32, logp and gradient within 2e-5 of max(1, |value|)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu import compiler as jcompiler
from exmc_tpu.benchmarks import validation as jvalidation
from exmc_tpu_torch import compiler as tcompiler
from exmc_tpu_torch.benchmarks import validation as tvalidation
from exmc_tpu_torch.interop import ir_from_reference


def _compare(jir, tir, ncp=True, n=4, seed=0, data=None):
    jm = jcompiler.compile_logp(jir, ncp=ncp)
    tm = tcompiler.compile_logp(tir, ncp=ncp, device="cpu")
    assert tm.size == jm.size
    x = np.random.default_rng(seed).uniform(-1.5, 1.5, size=(n, tm.size)).astype(np.float32)
    jl, jg = jax.vmap(lambda f: jm.value_and_grad(f, jm.data if data is None else data))(
        jnp.asarray(x))
    tl, tg = tm.value_and_grad(torch.as_tensor(x))
    jl, jg = np.asarray(jl), np.asarray(jg)
    assert np.all(np.isfinite(jl))
    err_lp = np.abs(tl.numpy() - jl) / np.maximum(1.0, np.abs(jl))
    err_g = np.abs(tg.numpy() - jg) / np.maximum(1.0, np.abs(jg).max(-1, keepdims=True))
    assert err_lp.max() <= 2e-5 and err_g.max() <= 2e-5, (err_lp.max(), err_g.max())
    return jm, tm, x


def _det_model(pkg, op):
    """A vector latent through one det op into a Normal likelihood."""
    B, d = pkg.Builder, pkg.dists
    rng = np.random.default_rng(1)
    ir = B.new_ir()
    ir = B.rv(ir, "s", d.HalfNormal, {"sigma": 1.0})
    ir = B.rv(ir, "v", d.Normal, {"mu": 0.0, "sigma": 1.0}, shape=(4,))
    ir = B.rv(ir, "w", d.Normal, {"mu": 0.5, "sigma": 2.0}, shape=(3,))
    mat = rng.normal(size=(5, 4)).astype(np.float32)
    if op == "dot":
        ir = B.det(ir, "out", "dot", [mat, "v"])
    elif op == "getitem":
        ir = B.det(ir, "out", "getitem", ["v", np.array([3, 0, 0, 2, 1, 3])])
    elif op == "smul_matrix":
        ir = B.det(ir, "out", "smul", [mat, "v"])
    elif op == "smul_scalar":
        ir = B.det(ir, "out", "smul", ["s", "v"])
    elif op == "cumsum":
        ir = B.det(ir, "out", "cumsum", ["v"])
    elif op == "stack":
        ir = B.det(ir, "out", "stack", ["s", 1.5, "s"])
    elif op == "concat":
        ir = B.det(ir, "out", "concat", ["v", "w", np.ones(2, np.float32)])
    elif op == "sum_mean":
        ir = B.det(ir, "t", "sum", ["v"])
        ir = B.det(ir, "out", "mean", ["w"])
        ir = B.det(ir, "out2", "add", ["t", "out"])
        ir = B.rv(ir, "y2", d.Normal, {"mu": "out2", "sigma": 1.0})
        ir = B.obs(ir, "y2_obs", "y2", 0.3)
    n_out = {"dot": 5, "getitem": 6, "smul_matrix": 5, "smul_scalar": 4, "cumsum": 4,
             "stack": 3, "concat": 9, "sum_mean": ()}[op]
    shape = (n_out,) if n_out else ()
    y = rng.normal(size=shape).astype(np.float32)
    ir = B.rv(ir, "y", d.Normal, {"mu": "out", "sigma": "s"}, shape=shape or None)
    ir = B.obs(ir, "y_obs", "y", y)
    return ir


@pytest.mark.parametrize("op", ["dot", "getitem", "smul_matrix", "smul_scalar", "cumsum",
                                "stack", "concat", "sum_mean"])
def test_det_ops_match_jax(op):
    _compare(_det_model(exmc_tpu, op), _det_model(exmc_tpu_torch, op))


def _obs_meta_model(pkg):
    B, d = pkg.Builder, pkg.dists
    rng = np.random.default_rng(2)
    ir = B.new_ir()
    ir = B.rv(ir, "mu", d.Normal, {"mu": 0.0, "sigma": 3.0})
    ir = B.rv(ir, "sig", d.HalfNormal, {"sigma": 2.0})
    for i, meta in enumerate([dict(weight=np.linspace(0.5, 2.0, 6).astype(np.float32)),
                              dict(mask=np.array([1, 0, 1, 1, 0, 1], bool)),
                              dict(reduce="mean"), dict(reduce="logsumexp"),
                              dict(likelihood=False)]):
        ir = B.rv(ir, f"y{i}", d.Normal, {"mu": "mu", "sigma": "sig"}, shape=(6,))
        ir = B.obs(ir, f"y{i}_obs", f"y{i}", rng.normal(size=6).astype(np.float32), **meta)
    return ir


def test_obs_meta_matches_jax():
    _compare(_obs_meta_model(exmc_tpu), _obs_meta_model(exmc_tpu_torch))


def _keyed_model(pkg):
    """Obs values read from a keyed data dict; a Custom density reads the
    model's own data through "__base"."""
    B, d = pkg.Builder, pkg.dists
    rng = np.random.default_rng(3)
    data = {"__base": rng.normal(size=5).astype(np.float32),
            "a": rng.normal(1.0, size=7).astype(np.float32),
            "b": rng.normal(-1.0, size=4).astype(np.float32)}
    xp = jnp if pkg is exmc_tpu else torch
    cust = d.Custom(logpdf_fn=lambda x, p, data=None: -0.5 * xp.sum((data - x) ** 2)
                    if pkg is exmc_tpu else -0.5 * ((data - x[..., None]) ** 2).sum(-1))
    ir = B.new_ir()
    ir = B.rv(ir, "mu", d.Normal, {"mu": 0.0, "sigma": 3.0})
    ir = B.rv(ir, "c", cust, {})
    ir = B.rv(ir, "ya", d.Normal, {"mu": "mu", "sigma": 1.0}, shape=(7,))
    ir = B.obs(ir, "ya_obs", "ya", ("__obs_data", "a"), reduce="sum")
    ir = B.rv(ir, "yb", d.Normal, {"mu": "c", "sigma": 2.0}, shape=(4,))
    ir = B.obs(ir, "yb_obs", "yb", ("__obs_data", "b"), reduce="sum")
    ir = B.det(ir, "base_mean", "mean", ["__obs_data"])
    ir = B.rv(ir, "z", d.Normal, {"mu": "base_mean", "sigma": 1.0})
    return B.data(ir, data), data


def test_keyed_data_and_base_match_jax():
    (jir, data), (tir, _) = _keyed_model(exmc_tpu), _keyed_model(exmc_tpu_torch)
    _compare(jir, tir, data=data)


def _meas_sampled_matrix(pkg):
    """A matmul lift whose matrix is a det node of a sampled scale: no
    constant solve at compile time, and no CUDA graph on the card."""
    B, d = pkg.Builder, pkg.dists
    a0 = np.array([[2.0, 0.3, 0.0], [0.1, 1.5, 0.2], [0.0, 0.4, 1.2]], np.float32)
    ir = B.new_ir()
    ir = B.rv(ir, "k", d.LogNormal, {"mu": 0.0, "sigma": 0.3})
    ir = B.det(ir, "A", "mul", ["k", a0])
    ir = B.rv(ir, "mu", d.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = B.rv(ir, "x", d.Normal, {"mu": "mu", "sigma": 1.0}, shape=(3,))
    ir = B.det(ir, "yd", "matmul", ["A", "x"])
    ir = B.obs(ir, "y_obs", "yd", np.array([1.0, -0.5, 2.0], np.float32))
    return ir


def test_meas_obs_with_a_sampled_matrix():
    _, tm, _ = _compare(_meas_sampled_matrix(exmc_tpu), _meas_sampled_matrix(exmc_tpu_torch))
    assert not isinstance(tm.value_and_grad, tcompiler.GraphedValueAndGrad)
    const = tcompiler.compile_logp(tvalidation.build_golds(["linreg_meas_obs_matmul"])[
        "linreg_meas_obs_matmul"].ir, device="cpu")
    assert isinstance(const.value_and_grad, tcompiler.GraphedValueAndGrad)


@pytest.mark.parametrize("part", ["prior", "likelihood"])
def test_partial_logp_matches_jax(part):
    jg = jvalidation._eight_schools()
    tg = tvalidation._eight_schools()
    jm, tm, x = _compare(jg.ir, tg.ir)
    jp = jax.vmap(jcompiler.partial_logp(jm, part))(jnp.asarray(x))
    tp = tcompiler.partial_logp(tm, part)(torch.as_tensor(x))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-5)
    total = sum(tcompiler.partial_logp(tm, p)(torch.as_tensor(x)) for p in ("prior", "likelihood"))
    np.testing.assert_allclose(total.numpy(), tm.logp(torch.as_tensor(x)).numpy(), rtol=1e-6,
                               atol=1e-5)
    with pytest.raises(ValueError):
        tcompiler.partial_logp(tm, "both")


def test_compile_pointwise_matches_jax():
    jir, tir = _obs_meta_model(exmc_tpu), _obs_meta_model(exmc_tpu_torch)
    jm = jcompiler.compile_logp(jir)
    x = np.random.default_rng(4).uniform(-1, 1, size=(3, jm.size)).astype(np.float32)
    jpw = jax.vmap(jcompiler.compile_pointwise(jir))(jnp.asarray(x))
    tpw = tcompiler.compile_pointwise(tir, device="cpu")(torch.as_tensor(x))
    assert sorted(tpw) == sorted(jpw)
    for k in jpw:
        np.testing.assert_allclose(tpw[k].numpy(), np.broadcast_to(np.asarray(jpw[k]),
                                                                   tpw[k].shape),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
        assert tpw[k].shape == (3, 6)


CARRIED = ["conjugate_normal", "mvn_conjugate", "eight_schools_ncp", "dirichlet_prior",
           "mvn_dense_mass", "linreg_meas_obs_matmul", "affine_meas_obs",
           "uniform_interval_normal", "mixture_loc", "censored_right_normal",
           "censored_interval_normal", "grw_kalman_t1000", "binomial_beta",
           "categorical_dirichlet", "lkj_marginals", "multinomial_dirichlet",
           "ordered_normal_orderstats", "zero_sum_normal_prior", "diabetes_real_logistic",
           "ordered_logistic_eta", "weibull_rate", "truncnorm_loc"]


@pytest.mark.parametrize("name", CARRIED)
def test_ir_from_reference_carries_the_gold(name):
    """The JAX gold's IR carried over compiles to the same log-density as
    the JAX gold, raw and already rewritten."""
    make = {tvalidation.gold_name(m): m for m in jvalidation._all_gold_standards()}[name]
    jg = make()
    _compare(jg.ir, ir_from_reference(jg.ir), ncp=jg.ncp)
    rw = exmc_tpu.rewrite.apply(jg.ir, ncp=jg.ncp)
    jm = jcompiler.compile_logp(rw, rewritten=True)
    tm = tcompiler.compile_logp(ir_from_reference(rw), rewritten=True, device="cpu")
    x = np.zeros((1, tm.size), np.float32)
    np.testing.assert_allclose(float(tm.logp(torch.as_tensor(x))[0]),
                               float(jm.logp(jnp.asarray(x[0]))), rtol=2e-5)


def test_ir_from_reference_refuses_callables_and_custom():
    gm = {m.__name__: m for m in jvalidation._all_gold_standards()}
    with pytest.raises(ValueError, match="callable"):
        ir_from_reference(gm["poisson_log_link"]().ir)
    with pytest.raises(ValueError, match="Custom"):
        ir_from_reference(gm["custom_gaussian_conjugate"]().ir)


def test_unknown_det_op_and_bad_obs_value_are_refused():
    B, d = exmc_tpu_torch.Builder, exmc_tpu_torch.dists
    ir = B.rv(B.new_ir(), "a", d.Normal, {"mu": 0.0, "sigma": 1.0})
    with pytest.raises(ValueError, match="unknown det op"):
        tcompiler.compile_logp(B.det(ir, "b", "nope", ["a"]), device="cpu")
    ir2 = B.rv(ir, "y", d.Normal, {"mu": "a", "sigma": 1.0})
    with pytest.raises(ValueError, match="bad obs value"):
        tcompiler.compile_logp(B.obs(ir2, "y_obs", "y", "elsewhere"), device="cpu")
