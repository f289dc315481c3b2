"""The port's constraint transforms against the JAX package's: forward,
inverse and log|det J| on the same inputs (JAX vmapped over the chain
axis the port carries), the log-Jacobian against autograd's Jacobian in
float64, the round trip, ``unconstrained_shape`` and the registry.

Tolerance: float32, 1e-5 relative on top of 1e-5 absolute; the float64
Jacobian checks 1e-8."""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from exmc_tpu import transforms as jtf
from exmc_tpu_torch import transforms as ttf

C = 6

# (name, port transform, JAX transform, unconstrained event shape)
CASES = [
    ("identity", ttf.IDENTITY, jtf.IDENTITY, (3,)),
    ("log", ttf.LOG, jtf.LOG, (4,)),
    ("softplus", ttf.SOFTPLUS, jtf.SOFTPLUS, (4,)),
    ("logit", ttf.LOGIT, jtf.LOGIT, (4,)),
    ("stick_breaking", ttf.STICK_BREAKING, jtf.STICK_BREAKING, (3,)),
    ("ordered", ttf.ORDERED, jtf.ORDERED, (4,)),
    ("zero_sum", ttf.ZERO_SUM, jtf.ZERO_SUM, (3,)),
    ("positive_ordered", ttf.POSITIVE_ORDERED, jtf.POSITIVE_ORDERED, (4,)),
    ("cholesky_corr", ttf.CHOLESKY_CORR, jtf.CHOLESKY_CORR, (6,)),
    ("interval", ttf.IntervalTransform(2.0, 5.0), jtf.IntervalTransform(2.0, 5.0), (3,)),
    ("lower_bound", ttf.LowerBoundTransform(-1.5), jtf.LowerBoundTransform(-1.5), (3,)),
    ("upper_bound", ttf.UpperBoundTransform(4.0), jtf.UpperBoundTransform(4.0), (3,)),
]
IDS = [c[0] for c in CASES]


def _z(ushape, seed, scale=1.5):
    return (np.random.default_rng(seed).normal(size=(C,) + ushape) * scale).astype(np.float32)


@pytest.mark.parametrize("name,tt,jt,ushape", CASES, ids=IDS)
def test_forward_inverse_ladj_match_jax(name, tt, jt, ushape):
    z = _z(ushape, 1)
    x_ref = np.asarray(jax.vmap(jt.forward)(jnp.asarray(z)))
    ladj_ref = np.asarray(jax.vmap(jt.log_abs_det_jacobian)(jnp.asarray(z)))
    x = tt.forward(torch.as_tensor(z))
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-5, atol=1e-5)
    ladj = tt.log_abs_det_jacobian(torch.as_tensor(z))
    assert ladj.shape == (C,)
    np.testing.assert_allclose(ladj.numpy(), np.broadcast_to(ladj_ref, (C,)),
                               rtol=1e-5, atol=1e-5)
    inv_ref = np.asarray(jax.vmap(jt.inverse)(jnp.asarray(x_ref)))
    np.testing.assert_allclose(tt.inverse(torch.as_tensor(x_ref)).numpy(), inv_ref,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,tt,jt,ushape", CASES, ids=IDS)
def test_ladj_gradient_matches_jax(name, tt, jt, ushape):
    """The gradient of log|det J| (what the sampler differentiates)."""
    z = _z(ushape, 2)
    ref = np.asarray(jax.vmap(jax.grad(lambda zz: jnp.sum(jt.log_abs_det_jacobian(zz))))(
        jnp.asarray(z)))
    zt = torch.as_tensor(z).requires_grad_(True)
    out = tt.log_abs_det_jacobian(zt)
    g = (torch.autograd.grad(out.sum(), zt)[0].numpy() if out.requires_grad
         else np.zeros_like(z))
    np.testing.assert_allclose(g, ref, rtol=1e-5, atol=1e-5)


def _coords(name, x):
    """The constrained coordinates the density is taken over: all but the
    last simplex entry; the strict lower triangle of L."""
    if name == "stick_breaking":
        return x[..., :-1]
    if name == "cholesky_corr":
        rows, cols = np.tril_indices(x.shape[-1], -1)
        return x[..., rows, cols]
    return x


@pytest.mark.parametrize("name,tt,jt,ushape", CASES, ids=IDS)
def test_ladj_equals_autograd_jacobian_f64(name, tt, jt, ushape):
    """log|det J| per chain equals log|det| of autograd's Jacobian of the
    forward map in float64 (zero_sum: the isometry's
    0.5 log det(J^T J) = 0)."""
    z = torch.as_tensor(_z(ushape, 3, scale=1.0), dtype=torch.float64)
    ladj = tt.log_abs_det_jacobian(z)
    for i in range(C):
        jac = torch.autograd.functional.jacobian(
            lambda zz: _coords(name, tt.forward(zz[None])[0]).reshape(-1), z[i])
        jac = jac.reshape(jac.shape[0], -1)
        if name == "zero_sum":
            want = 0.5 * torch.logdet(jac.T @ jac)
        else:
            want = torch.linalg.slogdet(jac)[1]
        np.testing.assert_allclose(float(ladj[i]), float(want), atol=1e-8)


@pytest.mark.parametrize("name,tt,jt,ushape", CASES, ids=IDS)
def test_round_trip_and_shapes(name, tt, jt, ushape):
    z = torch.as_tensor(_z(ushape, 4, scale=1.0), dtype=torch.float64)
    x = tt.forward(z)
    np.testing.assert_allclose(tt.inverse(x).numpy(), z.numpy(), atol=1e-9)
    cshape = tuple(x.shape[1:])
    assert tt.unconstrained_shape(cshape) == jt.unconstrained_shape(cshape) == ushape
    assert tt.constrained_shape(ushape) == jt.constrained_shape(ushape) == cshape
    assert ttf.unconstrained_shape(tt, cshape) == ushape


def test_transform_specific_constraints():
    z = torch.as_tensor(_z((5,), 5, scale=3.0), dtype=torch.float64)
    w = ttf.STICK_BREAKING.forward(z[:, :4])
    assert (w > 0).all() and torch.allclose(w.sum(-1), torch.ones(C, dtype=w.dtype))
    assert (torch.diff(ttf.ORDERED.forward(z), dim=-1) > 0).all()
    assert (torch.diff(ttf.POSITIVE_ORDERED.forward(z), dim=-1) > 0).all()
    assert torch.allclose(ttf.ZERO_SUM.forward(z).sum(-1), torch.zeros(C, dtype=z.dtype))
    L = ttf.CHOLESKY_CORR.forward(torch.as_tensor(_z((10,), 6), dtype=torch.float64))
    assert L.shape == (C, 5, 5)
    assert torch.allclose((L * L).sum(-1), torch.ones(C, 5, dtype=L.dtype))
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    x = ttf.IntervalTransform(2.0, 5.0).forward(z)
    assert ((x > 2.0) & (x < 5.0)).all()
    assert (ttf.LowerBoundTransform(-1.5).forward(z) > -1.5).all()
    assert (ttf.UpperBoundTransform(4.0).forward(z) < 4.0).all()


def test_log_clamp_edge_gradient_matches_jax():
    """The exp-based transforms clamp at +/-20 with jnp.clip's 0.5
    gradient at the edge."""
    z = np.array([[-25.0, -20.0, 0.0, 20.0, 25.0]], np.float32)
    for tt, jt in ((ttf.POSITIVE_ORDERED, jtf.POSITIVE_ORDERED),
                   (ttf.LowerBoundTransform(1.0), jtf.LowerBoundTransform(1.0))):
        ref = jax.grad(lambda zz: jnp.sum(jt.log_abs_det_jacobian(zz)))(jnp.asarray(z[0]))
        zt = torch.as_tensor(z).requires_grad_(True)
        (g,) = torch.autograd.grad(tt.log_abs_det_jacobian(zt).sum(), zt)
        np.testing.assert_array_equal(g.numpy()[0], np.asarray(ref))


@pytest.mark.parametrize("gold", ["dirichlet_prior", "lkj_marginals",
                                  "ordered_normal_orderstats",
                                  "zero_sum_normal_prior", "uniform_interval_normal"])
def test_point_map_matches_jax(gold):
    """PointMap over a gold's rewritten IR: the same entries (offsets,
    lengths, constrained and unconstrained shapes) as the JAX package's;
    ``to_constrained`` of a batch equals JAX's per row, and
    ``to_unconstrained`` / ``pack`` / ``unpack`` invert it."""
    from exmc_tpu import rewrite as jrewrite
    from exmc_tpu.benchmarks import validation as jvalidation
    from exmc_tpu.point_map import PointMap as JPointMap
    from exmc_tpu_torch import rewrite as trewrite
    from exmc_tpu_torch.benchmarks import validation as tvalidation
    from exmc_tpu_torch.point_map import PointMap

    tg = tvalidation.build_golds([gold])[gold]
    make = next(m for m in tvalidation.all_gold_standards()
                if tvalidation.gold_name(m) == gold)
    jg = {m.__name__: m for m in jvalidation._all_gold_standards()}[make.__name__]()
    jpm = JPointMap.build(jrewrite.apply(jg.ir, ncp=False))
    tpm = PointMap.build(trewrite.apply(tg.ir, ncp=False))
    assert tpm.size == jpm.size
    for je, te in zip(jpm.entries, tpm.entries, strict=True):
        assert (te.id, te.offset, te.length, tuple(te.shape), tuple(te.ushape)) == (
            je.id, je.offset, je.length, tuple(je.shape), tuple(je.ushape))
        assert tpm.entry(te.id) is te
    flat = np.random.default_rng(7).normal(size=(C, tpm.size)).astype(np.float32)
    got = tpm.to_constrained(torch.as_tensor(flat))
    for i in range(C):
        want = jpm.to_constrained(jnp.asarray(flat[i]))
        for k, v in want.items():
            np.testing.assert_allclose(got[k][i].numpy(), np.asarray(v),
                                       rtol=1e-5, atol=1e-5)
    back = tpm.to_unconstrained(got)
    np.testing.assert_allclose(back.numpy(), flat, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tpm.pack(tpm.unpack(torch.as_tensor(flat))).numpy(), flat)
    with pytest.raises(KeyError):
        tpm.entry("no_such_rv")


def test_registry_returns_all_twelve():
    names = ["identity", "log", "softplus", "logit", "stick_breaking",
             "cholesky_corr", "ordered", "positive_ordered", "zero_sum"]
    for n in names:
        assert ttf.get(n).name == n
    assert ttf.get(None) is ttf.IDENTITY
    bounded = {("interval", 2.0, 5.0): (2.0, 5.0), ("lower_bound", -1.0): (-1.0,),
               ("upper_bound", 3.0): (3.0,)}
    for spec in bounded:
        t = ttf.get(spec)
        assert t.name == spec[0]
    inst = ttf.IntervalTransform(0.0, 2.0)
    assert ttf.get(inst) is inst
    assert len(set(names) | {s[0] for s in bounded}) == 12
    with pytest.raises(ValueError):
        ttf.get("nope")
    assert math.isclose(float(ttf.get(("interval", 2.0, 5.0)).forward(torch.zeros(1))), 3.5)
