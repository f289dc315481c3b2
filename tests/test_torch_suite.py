"""The seven-model suite's model layer in the port, held against the JAX
package on the same numpy inputs: the new distributions (Exponential,
StudentT, Bernoulli, GaussianRandomWalk), the GRW kind of the NCP
rewrite, the matmul det op, the compiled log-density and its gradient,
constrained values, the spectral basis, and the IR carried over by
``interop``. Plus short CPU runs of the suite's recipe."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu import compiler as jcompiler
from exmc_tpu import rewrite as jrewrite
from exmc_tpu.benchmarks import suite as jsuite
from exmc_tpu_torch import compiler as tcompiler
from exmc_tpu_torch import rewrite as trewrite
from exmc_tpu_torch.benchmarks import suite as tsuite
from exmc_tpu_torch.interop import ir_from_reference
from exmc_tpu_torch.point_map import PointMap

EXPECTED_DIMS = {"simple": 2, "medium": 5, "stress": 8, "eight_schools": 10,
                 "funnel": 10, "logistic": 21, "sv": 102}
NAMES = sorted(EXPECTED_DIMS)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _models(name, **kw):
    """(JAX IR, port IR) of a suite model from each package's builder."""
    return jsuite.MODELS[name](**kw), tsuite.MODELS[name](**kw)


# (dist, params (values scaled per chain), value range) of the new dists
DIST_CASES = [
    ("Exponential", {"lambda": 0.7}, (0.01, 6.0)),
    ("StudentT", {"df": 0.6, "loc": 0.3, "scale": 1.7}, (-8.0, 8.0)),
    ("StudentT", {"df": 4.0, "loc": -1.0, "scale": 0.4}, (-8.0, 8.0)),
    ("Bernoulli", {"logits": 1.3}, None),
    ("Bernoulli", {"p": 0.3}, None),
]


@pytest.mark.parametrize("name,params,rng_x", DIST_CASES)
def test_new_dist_logpdf_and_grad_match_jax(name, params, rng_x):
    """logpdf and its gradient in the value and every parameter, with
    parameters varying per chain as referenced RVs give them (StudentT
    at df 0.6 runs lgamma's gradient, digamma, at small df). f32
    tolerance: 1e-5 relative on top of 1e-5 absolute."""
    rng = np.random.default_rng(3)
    if rng_x is None:
        x = (rng.uniform(size=(5, 7)) < 0.5).astype(np.float32)
    else:
        x = rng.uniform(*rng_x, size=(5, 7)).astype(np.float32)
    pv = {k: (v * rng.uniform(0.5, 1.5, size=(5, 1))).astype(np.float32)
          for k, v in params.items()}
    jd, td = getattr(exmc_tpu.dists, name), getattr(exmc_tpu_torch.dists, name)

    def jlp(x, pv):
        return jnp.sum(jd.logpdf(x, pv))

    ref = jd.logpdf(jnp.asarray(x), {k: jnp.asarray(v) for k, v in pv.items()})
    jg = jax.grad(jlp, argnums=(0, 1))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in pv.items()})
    xt = _t(x).requires_grad_(True)
    pt = {k: _t(v).requires_grad_(True) for k, v in pv.items()}
    got = td.logpdf(xt, pt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(got.sum(), [xt] + list(pt.values()))
    want = [jg[0]] + [jg[1][k] for k in pt]
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_grw_logpdf_matches_jax_per_chain():
    """Increments along the event axis only: row i of the batched logpdf
    is the JAX logpdf of path i."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 30)).cumsum(-1).astype(np.float32)
    sig = rng.uniform(0.3, 2.0, size=(6, 1)).astype(np.float32)
    jd = exmc_tpu.dists.GaussianRandomWalk
    ref = [float(jd.logpdf(jnp.asarray(x[i]), {"sigma": jnp.asarray(sig[i, 0])}))
           for i in range(6)]
    xt, st = _t(x).requires_grad_(True), _t(sig).requires_grad_(True)
    got = exmc_tpu_torch.dists.GaussianRandomWalk.logpdf(xt, {"sigma": st})
    assert got.shape == (6,)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5)
    gx, gs = torch.autograd.grad(got.sum(), [xt, st])
    jgx, jgs = jax.vmap(jax.grad(lambda xx, ss: jd.logpdf(xx, {"sigma": ss}),
                                 argnums=(0, 1)))(jnp.asarray(x),
                                                  jnp.asarray(sig[:, 0]))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gs.numpy()[:, 0], np.asarray(jgs), rtol=1e-5)


def test_sample_moments():
    """Normal, HalfNormal and Exponential draws from an explicit
    generator: reproducible, with the right first two moments."""
    d = exmc_tpu_torch.dists
    cases = [(d.Normal, {"mu": _t(1.5), "sigma": _t(2.0)}, 1.5, 2.0),
             (d.HalfNormal, {"sigma": _t(2.0)}, 2.0 * np.sqrt(2 / np.pi),
              2.0 * np.sqrt(1 - 2 / np.pi)),
             (d.Exponential, {"lambda": _t(4.0)}, 0.25, 0.25)]
    for dist, params, mean, sd in cases:
        g = torch.Generator().manual_seed(0)
        a = dist.sample(params, (200_000,), g)
        b = dist.sample(params, (200_000,), torch.Generator().manual_seed(0))
        assert torch.equal(a, b) and a.dtype == torch.float32
        assert abs(float(a.mean()) - mean) < 5 * sd / np.sqrt(2e5)
        assert abs(float(a.std()) - sd) < 0.01 * sd


@pytest.mark.parametrize("name", NAMES)
def test_model_dimension(name):
    m = tcompiler.compile_logp(tsuite.build_model(name), ncp=False,
                               device="cpu")
    assert m.size == EXPECTED_DIMS[name]


def _op_summary(x):
    """A comparable summary of an op tuple: dists and transforms by name,
    arrays as nested lists, containers recursively."""
    if hasattr(x, "name"):
        return ("obj", x.name)
    if isinstance(x, dict):
        return ("dict", tuple(sorted((k, _op_summary(v)) for k, v in x.items())))
    if isinstance(x, (tuple, list)):
        return tuple(_op_summary(v) for v in x)
    if isinstance(x, (str, type(None))):
        return x
    return str(np.asarray(x).tolist())


def _assert_same_ir(a, b):
    assert sorted(a.nodes) == sorted(b.nodes)
    for nid in a.nodes:
        assert _op_summary(a.nodes[nid].op) == _op_summary(b.nodes[nid].op), nid
        assert tuple(a.nodes[nid].deps) == tuple(b.nodes[nid].deps)
        assert a.nodes[nid].shape == b.nodes[nid].shape
    assert a.ncp_info == b.ncp_info


REWRITE_CASES = [(n, {}) for n in NAMES] + [("sv", {"t": 20})]


@pytest.mark.parametrize("name,kw", REWRITE_CASES)
@pytest.mark.parametrize("ncp", [True, False])
def test_rewrite_matches_jax(name, kw, ncp):
    """Incl. the GRW kind: sv at T=100 is spectral, at T=20 it is not."""
    jir, tir = _models(name, **kw)
    jr, tr = jrewrite.apply(jir, ncp=ncp), trewrite.apply(tir, ncp=ncp)
    _assert_same_ir(jr, tr)
    if name == "sv" and ncp:
        assert tr.ncp_info["s"]["kind"] == "grw"
        assert tr.ncp_info["s"]["spectral"] is (kw.get("t", 100) >= 64)


def _jax_model(jir, ncp):
    m = jcompiler.compile_logp(jir, ncp=ncp)
    return m, jax.jit(jax.vmap(m.value_and_grad))


VAG_CASES = [(n, ncp) for n in NAMES for ncp in (True, False)]


@pytest.mark.parametrize("name,ncp", VAG_CASES)
def test_value_and_grad_matches_jax(name, ncp):
    """16 seeded points; 1e-4 relative (the sv spectral basis is a
    (100, 100) f32 product, summed in another order than XLA's)."""
    jir, tir = _models(name)
    jm, jvag = _jax_model(jir, ncp)
    tm = tcompiler.compile_logp(tir, ncp=ncp, device="cpu")
    assert [e.id for e in jm.pm.entries] == [e.id for e in tm.pm.entries]
    flat = np.random.default_rng(5).uniform(-1, 1, size=(16, tm.size)).astype(np.float32)
    lj, gj = jvag(jnp.asarray(flat))
    lt, gt = tm.value_and_grad(_t(flat))
    assert lt.shape == (16,) and gt.shape == (16, tm.size)
    lj, gj = np.asarray(lj), np.asarray(gj)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=1e-4,
                               atol=1e-4 * np.abs(lj).max())
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4,
                               atol=1e-4 * np.abs(gj).max())


@pytest.mark.parametrize("name,ncp", VAG_CASES)
def test_constrain_matches_jax(name, ncp):
    jir, tir = _models(name)
    jm, _ = _jax_model(jir, ncp)
    tm = tcompiler.compile_logp(tir, ncp=ncp, device="cpu")
    flat = np.random.default_rng(8).uniform(-1, 1, size=(4, tm.size)).astype(np.float32)
    ref = jax.vmap(lambda f: jcompiler.constrain_flat(jm.ir, jm.pm, f))(jnp.asarray(flat))
    got = tm.constrain(_t(flat))
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [5, 64, 100])
def test_spectral_basis_and_ncp_invert_match_jax(t):
    v = tcompiler._grw_spectral_basis(t)
    np.testing.assert_array_equal(v, np.asarray(jcompiler._grw_spectral_basis(t)))
    np.testing.assert_allclose(v @ v.T, np.eye(t), atol=1e-12)
    rng = np.random.default_rng(t)
    x = rng.normal(size=(3, t)).cumsum(-1).astype(np.float32)
    sig = rng.uniform(0.5, 2.0, size=(3, 1)).astype(np.float32)
    for info in ({"kind": "grw", "spectral": True}, {"kind": "grw"}, {}):
        ref = jax.vmap(lambda xx, ss: jcompiler._ncp_invert(
            info, xx, jnp.float32(0.3), ss))(jnp.asarray(x), jnp.asarray(sig[:, 0]))
        got = tcompiler._ncp_invert(info, _t(x), 0.3, _t(sig))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_spectral_reconstruction_inverts():
    """constrain_flat's s = sigma * cumsum(V w) and _ncp_invert's
    w = V^T diff(s) / sigma are inverse maps."""
    tm = tcompiler.compile_logp(tsuite.sv_model(), device="cpu")
    flat = _t(np.random.default_rng(9).uniform(-1, 1, size=(3, tm.size)))
    vals = tm.constrain(flat)
    w = tcompiler._ncp_invert(tm.ncp_info["s"], vals["s"], 0.0,
                              vals["sigma"][:, None])
    e = next(e for e in tm.pm.entries if e.id == "s")
    np.testing.assert_allclose(w.numpy(), flat[:, e.offset:e.offset + e.length].numpy(),
                               atol=2e-4)


def test_matmul_is_per_chain():
    """A constant (1, m, k) design matrix against (C, k) coefficients:
    row i of the (C, m) product is X @ beta_i; a chain-batched matrix
    and the vector cases follow JAX's matmul of one point."""
    rng = np.random.default_rng(10)
    x = _t(rng.normal(size=(7, 3)))
    beta = _t(rng.normal(size=(4, 3)))
    out = tcompiler._matmul(x[None], beta)
    assert out.shape == (4, 7)
    for i in range(4):
        np.testing.assert_allclose(out[i].numpy(), (x @ beta[i]).numpy(), rtol=1e-6)
    xb = _t(rng.normal(size=(4, 7, 3)))
    np.testing.assert_allclose(tcompiler._matmul(xb, beta)[2].numpy(),
                               (xb[2] @ beta[2]).numpy(), rtol=1e-6)
    a = _t(rng.normal(size=(4, 3)))
    np.testing.assert_allclose(tcompiler._matmul(a, beta).numpy(),
                               (a * beta).sum(-1).numpy(), rtol=1e-6)
    m = _t(rng.normal(size=(4, 3, 2)))
    np.testing.assert_allclose(tcompiler._matmul(a, m)[1].numpy(),
                               (a[1] @ m[1]).numpy(), rtol=1e-6)


def test_logistic_batch_independence():
    """Row i of the batched logistic value-and-grad equals the call on
    row i alone, also next to a non-finite row, up to the rounding of
    the (C, 20) x (20, 500) product, whose blocking may depend on C."""
    tm = tcompiler.compile_logp(tsuite.logistic_model(), device="cpu")
    flat = _t(np.random.default_rng(6).uniform(-1, 1, size=(5, tm.size)))
    flat[2] = float("nan")
    lb, gb = tm.value_and_grad(flat)
    for i in (0, 4):
        li, gi = tm.value_and_grad(flat[i:i + 1])
        np.testing.assert_allclose(lb[i:i + 1].numpy(), li.numpy(), rtol=1e-5)
        np.testing.assert_allclose(gb[i:i + 1].numpy(), gi.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert np.isnan(lb[2].item())


def test_grw_requires_explicit_shape():
    d = exmc_tpu_torch.dists
    ir = exmc_tpu_torch.Builder.new_ir()
    ir = exmc_tpu_torch.Builder.rv(ir, "sigma", d.HalfNormal, {"sigma": 1.0})
    ir = exmc_tpu_torch.Builder.rv(ir, "s", d.GaussianRandomWalk,
                                   {"sigma": "sigma"})
    with pytest.raises(ValueError, match="explicit shape"):
        PointMap.build(trewrite.apply(ir, ncp=False))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("rewritten", [False, True])
def test_ir_from_reference(name, rewritten):
    jir, tir = _models(name)
    if rewritten:
        jir, tir = jrewrite.apply(jir), trewrite.apply(tir)
    got = ir_from_reference(jir)
    _assert_same_ir(got, tir)
    a = tcompiler.compile_logp(got, device="cpu", rewritten=rewritten)
    b = tcompiler.compile_logp(tir, device="cpu", rewritten=rewritten)
    flat = _t(np.random.default_rng(9).uniform(-1, 1, size=(4, b.size)))
    np.testing.assert_array_equal(a.logp(flat).numpy(), b.logp(flat).numpy())


@pytest.mark.parametrize("name", ["eight_schools", "sv", "logistic"])
def test_suite_recipe_runs_on_cpu(name):
    """A short run of the model under the recipe through ``run_model``:
    finite draws of the recipe's shapes, the port's extra fields, and
    iw_accept where the recipe interweaves."""
    res = tsuite.run_model(name, num_chains=4, num_warmup=20, num_samples=10,
                           device="cpu", warm_up=(2, 2))
    assert res["all_finite"] and res["d"] == EXPECTED_DIMS[name]
    assert res["host_syncs_per_iter"] > 0 and res["mean_depth"] >= 1
    assert (res["iw_accept_mean"] is None) == (
        not tsuite.SUITE_RECIPE[name]["opts"].get("interweave"))
    assert sorted(res["posterior"]) == sorted(tsuite.GATE_PARAMS[name])


@pytest.mark.gpu
def test_graphed_value_and_grad_on_card():
    """On the card value_and_grad replays a CUDA graph per batch shape:
    it equals the eager call, and each call's outputs stay valid after
    the next replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name, ncp in (("eight_schools", False), ("sv", True), ("logistic", True)):
        m = tcompiler.compile_logp(tsuite.build_model(name), ncp=ncp,
                                   device="cuda")
        vag = m.value_and_grad
        assert isinstance(vag, tcompiler.GraphedValueAndGrad)
        rng = np.random.default_rng(12)
        for c in (64, 16):
            a = _t(rng.uniform(-1, 1, size=(c, m.size))).cuda()
            b = _t(rng.uniform(-1, 1, size=(c, m.size))).cuda()
            la, ga = vag(a)
            lb, gb = vag(b)
            for (lg, gg), x in (((la, ga), a), ((lb, gb), b)):
                le, ge = vag.eager(x)
                np.testing.assert_allclose(lg.cpu().numpy(), le.cpu().numpy(),
                                           rtol=1e-6, atol=1e-6)
                np.testing.assert_allclose(gg.cpu().numpy(), ge.cpu().numpy(),
                                           rtol=1e-6, atol=1e-6)
        assert len(vag.graphs) == 2
