"""The PyTorch port's model layer held against the JAX package on the
same inputs: distributions, transforms, the rewrite passes, the compiled
batched log-density and the IR carried across by ``interop``."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu import compiler as jcompiler
from exmc_tpu import rewrite as jrewrite
from exmc_tpu import transforms as jtf
from exmc_tpu_torch import compiler as tcompiler
from exmc_tpu_torch import rewrite as trewrite
from exmc_tpu_torch import transforms as ttf
from exmc_tpu_torch.interop import ir_from_reference

ATOL = 2e-4  # as tests/test_dists.py

Y8 = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
S8 = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]
YS = np.array([2.1, 1.8, 2.5, 2.0, 1.9, 2.3, 2.2, 1.7, 2.4, 2.6])


def eight_schools(pkg):
    """The same model script builds either package's IR."""
    B, d = pkg.Builder, pkg.dists
    ir = B.new_ir()
    ir = B.rv(ir, "mu", d.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = B.rv(ir, "tau", d.HalfCauchy, {"scale": 5.0})
    for i in range(8):
        ir = B.rv(ir, f"theta_{i}", d.Normal, {"mu": "mu", "sigma": "tau"})
        ir = B.rv(ir, f"y_{i}", d.Normal, {"mu": f"theta_{i}", "sigma": S8[i]})
        ir = B.obs(ir, f"y_{i}_obs", f"y_{i}", Y8[i])
    return ir


def quickstart(pkg):
    B, d = pkg.Builder, pkg.dists
    ir = B.new_ir()
    ir = B.rv(ir, "mu", d.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = B.rv(ir, "sigma", d.HalfNormal, {"sigma": 2.0})
    ir = B.rv(ir, "x", d.Normal, {"mu": "mu", "sigma": "sigma"})
    return B.obs(ir, "x_obs", "x", YS)


MODELS = {"eight_schools": eight_schools, "quickstart": quickstart}


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("name,params,lo", [
    ("Normal", {"mu": 0.7, "sigma": 1.9}, -6.0),
    ("HalfNormal", {"sigma": 2.5}, 0.01),
    ("HalfCauchy", {"scale": 5.0}, 0.01),
])
def test_logpdf_matches_jax(name, params, lo):
    rng = np.random.default_rng(3)
    x = rng.uniform(lo, 6.0, size=(5, 7)).astype(np.float32)
    # per-chain parameter values, as a referenced RV gives them
    pv = {k: (v * rng.uniform(0.5, 1.5, size=(5, 1))).astype(np.float32)
          for k, v in params.items()}
    ref = getattr(exmc_tpu.dists, name).logpdf(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in pv.items()})
    got = getattr(exmc_tpu_torch.dists, name).logpdf(
        _t(x), {k: _t(v) for k, v in pv.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("tname", ["log", "softplus"])
def test_transform_elementwise(tname):
    rng = np.random.default_rng(4)
    z = rng.normal(scale=3.0, size=(6, 5)).astype(np.float32)
    jt, tt = jtf.get(tname), ttf.get(tname)
    np.testing.assert_allclose(tt.forward(_t(z)).numpy(),
                               np.asarray(jt.forward(jnp.asarray(z))),
                               rtol=1e-6, atol=1e-6)
    x = np.abs(z) + 0.1
    np.testing.assert_allclose(tt.inverse(_t(x)).numpy(),
                               np.asarray(jt.inverse(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    ladj_ref = np.array([float(jt.log_abs_det_jacobian(jnp.asarray(row)))
                         for row in z])
    np.testing.assert_allclose(tt.log_abs_det_jacobian(_t(z)).numpy(),
                               ladj_ref, rtol=1e-6, atol=1e-6)


def test_log_transform_gradient_at_clamp_edge():
    """Both sides of the +/-20 clamp and the edge itself, where JAX's
    clip splits the gradient (0.5)."""
    z = np.array([-25.0, -20.0, -19.9, 0.0, 19.9, 20.0, 25.0], np.float32)
    for fn in ("forward", "log_abs_det_jacobian"):
        ref = jax.vmap(jax.grad(lambda v: getattr(jtf.LOG, fn)(v)))(jnp.asarray(z))
        zt = _t(z).reshape(-1, 1).requires_grad_(True)
        (got,) = torch.autograd.grad(getattr(ttf.LOG, fn)(zt).sum(), zt)
        np.testing.assert_allclose(got.numpy().ravel(), np.asarray(ref),
                                   rtol=1e-6, atol=1e-12)


def _op_summary(op):
    out = []
    for x in op:
        if hasattr(x, "name"):
            out.append(("obj", x.name))
        elif isinstance(x, dict):
            out.append(("dict", tuple(sorted(
                (k, str(np.asarray(v).tolist()) if not isinstance(v, str) else v)
                for k, v in x.items()))))
        elif isinstance(x, (str, type(None))):
            out.append(x)
        else:
            out.append(str(np.asarray(x).tolist()))
    return tuple(out)


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("ncp", [True, False])
def test_rewrite_matches_jax(model, ncp):
    jr = jrewrite.apply(MODELS[model](exmc_tpu), ncp=ncp)
    tr = trewrite.apply(MODELS[model](exmc_tpu_torch), ncp=ncp)
    assert sorted(jr.nodes) == sorted(tr.nodes)
    for nid in jr.nodes:
        assert _op_summary(jr.nodes[nid].op) == _op_summary(tr.nodes[nid].op), nid
        assert tuple(jr.nodes[nid].deps) == tuple(tr.nodes[nid].deps)
    assert jr.ncp_info == tr.ncp_info


def _jax_vag(ir):
    m = jcompiler.compile_logp(ir)
    return m, jax.jit(jax.vmap(m.value_and_grad))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_value_and_grad_matches_jax(model):
    jm, jvag = _jax_vag(MODELS[model](exmc_tpu))
    tm = tcompiler.compile_logp(MODELS[model](exmc_tpu_torch), device="cpu")
    assert [e.id for e in jm.pm.entries] == [e.id for e in tm.pm.entries]
    flat = np.random.default_rng(5).uniform(-2, 2, size=(16, tm.size)).astype(np.float32)
    lj, gj = jvag(jnp.asarray(flat))
    lt, gt = tm.value_and_grad(_t(flat))
    assert lt.shape == (16,) and gt.shape == (16, tm.size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5, atol=1e-4)
    # gradients reach ~5e2 at small scales, where one f32 ulp is 6e-5:
    # the same rtol as logp on top of the absolute 1e-4
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_batch_independence(model):
    """Row i of the batched call equals the call on row i alone, also
    when another row of the batch is not finite: the chain-summed
    backward gives each chain its own gradient."""
    tm = tcompiler.compile_logp(MODELS[model](exmc_tpu_torch), device="cpu")
    flat = _t(np.random.default_rng(6).uniform(-2, 2, size=(8, tm.size)))
    flat[3] = float("nan")
    lb, gb = tm.value_and_grad(flat)
    for i in (0, 1, 5, 7):
        li, gi = tm.value_and_grad(flat[i:i + 1])
        np.testing.assert_array_equal(lb[i:i + 1].numpy(), li.numpy())
        np.testing.assert_array_equal(gb[i:i + 1].numpy(), gi.numpy())
    assert np.isnan(lb[3].item())


@pytest.mark.parametrize("model", sorted(MODELS))
def test_constrain_matches_jax(model):
    jm, _ = _jax_vag(MODELS[model](exmc_tpu))
    tm = tcompiler.compile_logp(MODELS[model](exmc_tpu_torch), device="cpu")
    flat = np.random.default_rng(8).uniform(-2, 2, size=(4, tm.size)).astype(np.float32)
    ref = jax.vmap(lambda f: jcompiler.constrain_flat(jm.ir, jm.pm, f))(jnp.asarray(flat))
    got = tm.constrain(_t(flat))
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("rewritten", [False, True])
def test_ir_from_reference(model, rewritten):
    """The JAX IR carried over equals the port's own IR of the same
    script, and compiles to the same log-density."""
    jir = MODELS[model](exmc_tpu)
    tir = MODELS[model](exmc_tpu_torch)
    if rewritten:
        jir, tir = jrewrite.apply(jir), trewrite.apply(tir)
    got = ir_from_reference(jir)
    assert sorted(got.nodes) == sorted(tir.nodes)
    for nid in tir.nodes:
        assert _op_summary(got.nodes[nid].op) == _op_summary(tir.nodes[nid].op)
        assert got.nodes[nid].deps == tir.nodes[nid].deps
    assert got.ncp_info == tir.ncp_info
    a = tcompiler.compile_logp(got, device="cpu", rewritten=rewritten)
    b = tcompiler.compile_logp(tir, device="cpu", rewritten=rewritten)
    flat = _t(np.random.default_rng(9).uniform(-2, 2, size=(4, b.size)))
    np.testing.assert_array_equal(a.logp(flat).numpy(), b.logp(flat).numpy())


def test_cuda_without_card_raises():
    """Asking for the card never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tcompiler.compile_logp(eight_schools(exmc_tpu_torch))
