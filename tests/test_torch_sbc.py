"""Simulation-based calibration in the port (CPU):

* ``rank_uniformity`` and ``ecdf_ks`` against the JAX package's on the
  same ranks (statistics and the ECDF p exact; the chi^2 p to 1e-5
  relative, since JAX evaluates the incomplete gamma in float32);
* ``_data_arg_ir`` rewrites the same nodes to the same keyed refs and
  data as JAX's;
* per-replication data: the log-density and gradient of a batch whose
  data leaves carry a chain axis of R equal R separate calls (1e-6),
  for vector obs, a matmul and an affine ``meas_obs``, a matrix-valued
  (MvNormal) obs, a censored obs, and masked and weighted obs beside
  the model's own ``"__base"`` data;
* a grouped ChEES, SNAPER and MEADS run of R ensembles of M chains
  equal to R runs of one ensemble each under the same injected draws
  (1e-6: the per-group statistics are the one-ensemble functions
  vmapped);
* ``rep_batch``: a batch of R or more is bit for bit the single batch;
  smaller batches (a short padded last one) give other draws of the
  same calibration, held to the JAX package's SBC gates;
* the argument checks.

The other small SBC runs are in ``test_torch_sbc_runs.py``.
"""

import numpy as np
import pytest
import torch

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu import sbc as jsbc
from exmc_tpu_torch import chees, meads
from exmc_tpu_torch import sbc as tsbc
from exmc_tpu_torch.benchmarks import post
from exmc_tpu_torch.compiler import compile_logp
from exmc_tpu_torch.nuts.masked import HostSyncs


def test_rank_tests_equal_jax():
    rng = np.random.default_rng(0)
    for r, L in ((400, 50), (60, 30), (128, 100)):
        for ranks in (rng.integers(0, L + 1, r), rng.integers(0, L // 3, r)):
            s1, p1 = tsbc.rank_uniformity(ranks, L)
            s2, p2 = jsbc.rank_uniformity(ranks, L)
            assert s1 == s2
            assert p1 == pytest.approx(p2, rel=1e-5, abs=1e-30)
            assert tsbc.ecdf_ks(ranks, L, seed=3) == jsbc.ecdf_ks(ranks, L, seed=3)


def _multi(pkg, with_base=False):
    """Vector, matrix-valued and affine-lifted observations, and data
    read by a plain ``"__obs_data"`` ref when ``with_base``."""
    B, D = pkg.Builder, pkg.dists
    ir = B.rv(B.new_ir(), "mu", D.Normal, {"mu": 0.0, "sigma": 2.0})
    ir = B.rv(ir, "sigma", D.HalfNormal, {"sigma": 1.0})
    ir = B.rv(ir, "x", D.Normal, {"mu": "mu", "sigma": "sigma"}, shape=(6,))
    ir = B.obs(ir, "x_obs", "x", np.linspace(0, 1, 6), weight=np.linspace(0.5, 1.5, 6),
               mask=np.array([1, 1, 0, 1, 1, 1], bool))
    ir = B.rv(ir, "v", D.MvNormal, {"mu": np.zeros(2), "cov": np.array([[1.0, 0.3],
                                                                       [0.3, 2.0]])},
              shape=(4, 2))
    ir = B.obs(ir, "v_obs", "v", np.zeros((4, 2), np.float32))
    ir = B.rv(ir, "z", D.Normal, {"mu": "mu", "sigma": 1.0}, shape=(3,))
    ir = B.det(ir, "zt", "affine", [2.0, 1.0, "z"])
    ir = B.obs(ir, "zt_obs", "zt", np.zeros(3, np.float32))
    if with_base:
        ir = B.data(ir, np.array([0.2, 0.7], np.float32))
        ir = B.rv(ir, "w", D.Normal, {"mu": "mu", "sigma": 1.0}, shape=(2,))
        ir = B.obs(ir, "w_obs", "w", "__obs_data")
    return ir


def _matmul(pkg):
    B, D = pkg.Builder, pkg.dists
    a = np.array([[2.0, 0.5, 0.0], [0.1, 1.0, 0.3], [0.0, 0.2, 1.5]], np.float32)
    ir = B.rv(B.new_ir(), "mu", D.Normal, {"mu": 0.0, "sigma": 2.0})
    ir = B.rv(ir, "x", D.Normal, {"mu": "mu", "sigma": 1.0}, shape=(3,))
    ir = B.det(ir, "ax", "matmul", [a, "x"])
    return B.obs(ir, "ax_obs", "ax", np.zeros(3, np.float32))


def _censored(pkg):
    B, D = pkg.Builder, pkg.dists
    ir = B.rv(B.new_ir(), "mu", D.Normal, {"mu": 0.0, "sigma": 2.0})
    ir = B.rv(ir, "y", D.Normal, {"mu": "mu", "sigma": 1.0}, shape=(5,))
    return B.obs(ir, "y_obs", "y", np.full(5, 1.5, np.float32), censored="right")


def test_data_arg_ir_equals_jax():
    for with_base in (False, True):
        want = jsbc._data_arg_ir(_multi(exmc_tpu, with_base),
                                 jsbc._obs_nodes(_multi(exmc_tpu, with_base)))
        ir = _multi(exmc_tpu_torch, with_base)
        got = tsbc._data_arg_ir(ir, tsbc._obs_nodes(ir))
        assert sorted(got.data) == sorted(want.data)
        for k in got.data:
            np.testing.assert_array_equal(np.asarray(got.data[k]), np.asarray(want.data[k]))
        for nid, node in want.nodes.items():
            if node.op[0] in ("obs", "meas_obs"):
                assert got.nodes[nid].op[2] == node.op[2] == ("__obs_data", nid)
    with pytest.raises(ValueError, match="no observation"):
        tsbc._obs_nodes(exmc_tpu_torch.Builder.new_ir())


@pytest.mark.parametrize("name", ["multi", "multi_base", "matmul", "censored"])
def test_replication_data_rows_equal_separate_calls(name):
    ir = {"multi": lambda: _multi(exmc_tpu_torch), "multi_base": lambda: _multi(
        exmc_tpu_torch, True), "matmul": lambda: _matmul(exmc_tpu_torch),
        "censored": lambda: _censored(exmc_tpu_torch)}[name]()
    obs = tsbc._obs_nodes(ir)
    ir2 = tsbc._data_arg_ir(ir, obs)
    model = compile_logp(ir2, device="cpu")
    r = 5
    rng = np.random.default_rng(1)
    rows = {k: rng.normal(size=(r,) + np.shape(v)).astype(np.float32)
            for k, v in ir2.data.items() if k != "__base"}
    base = ir2.data.get("__base")
    q = torch.as_tensor(rng.normal(size=(r, model.size)), dtype=torch.float32)
    lp, g = model.value_and_grad(q, tsbc._replication_data(rows, base, "cpu"))
    for i in range(r):
        one = {k: v[i] for k, v in rows.items()}
        if base is not None:
            one["__base"] = base
        lp1, g1 = model.value_and_grad(q[i:i + 1], one)
        np.testing.assert_allclose(lp[i].numpy(), lp1[0].numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g[i].numpy(), g1[0].numpy(), rtol=1e-6, atol=1e-6)
    # constraining pairs draw rows with their replication's data
    named = tsbc._constrain_rows(model, tsbc._replication_data(rows, base, "cpu"),
                                 q.reshape(r, 1, -1).repeat(1, 3, 1))
    assert all(v.shape[:2] == (r, 3) for v in named.values())


@pytest.mark.parametrize("criterion", ["chees", "snaper"])
def test_grouped_chees_equals_separate_runs(criterion):
    model = compile_logp(post.normal_loc_scale_ir(), device="cpu")
    g, m, w, s, d = 3, 4, 20, 10, model.size
    rng = np.random.default_rng(0)
    q0 = torch.as_tensor(rng.uniform(-1, 1, (g * m, d)), dtype=torch.float32)
    lp, gr = model.value_and_grad(q0)
    z_eps = torch.as_tensor(rng.normal(size=(g, d)), dtype=torch.float32)
    zs = torch.as_tensor(rng.normal(size=(w + s, g * m, d)), dtype=torch.float32)
    us = torch.as_tensor(rng.uniform(size=(w + s, g * m)), dtype=torch.float32)
    kernel = chees._Kernel(w, s)
    vag = model.value_and_grad
    carry = chees._init_carry(vag, q0, lp, gr, z_eps, criterion, HostSyncs())
    carry, outs = chees._run(vag, carry, kernel, 0.651, 1024, criterion,
                             lambda i: (zs[i], us[i]), HostSyncs())
    assert outs["num_steps"].shape == (w + s, g)
    for k in range(g):
        sl = slice(k * m, (k + 1) * m)
        c1 = chees._init_carry(vag, q0[sl], lp[sl], gr[sl], z_eps[k:k + 1], criterion,
                               HostSyncs())
        c1, o1 = chees._run(vag, c1, kernel, 0.651, 1024, criterion,
                            lambda i: (zs[i][sl], us[i][sl]), HostSyncs())
        np.testing.assert_allclose(outs["q"][sl].numpy(), o1["q"].numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(outs["num_steps"][:, k], o1["num_steps"][:, 0])
        np.testing.assert_allclose(float(carry["logT_bar"][k]), float(c1["logT_bar"][0]),
                                   rtol=1e-6)
        np.testing.assert_allclose(carry["inv"][k].numpy(), c1["inv"][0].numpy(),
                                   rtol=1e-6)


def test_grouped_meads_equals_separate_runs():
    model = compile_logp(post.normal_loc_scale_ir(), device="cpu")
    g, m, folds, w, s, d = 3, 8, 4, 20, 10, model.size
    rng = np.random.default_rng(1)
    q0 = torch.as_tensor(rng.uniform(-1, 1, (g * m, d)), dtype=torch.float32)
    u0 = torch.as_tensor(rng.normal(size=(g * m, d)), dtype=torch.float32)
    xs = torch.as_tensor(rng.normal(size=(w + s, g * m, d)), dtype=torch.float32)
    us = torch.as_tensor(rng.uniform(size=(w + s, g * m)), dtype=torch.float32)
    kernel = meads._Kernel(w, s)
    lp, gr = model.value_and_grad(q0)
    carry = dict(q=q0, logp=lp, grad=gr, u=u0)
    steps = []
    for i in range(w + s):
        carry, out, eps, gamma = meads._step(
            model.value_and_grad, carry, float(kernel.jitter[i]), xs[i], us[i], folds,
            1.0, None, g)
        steps.append(out["q"])
    for k in range(g):
        sl = slice(k * m, (k + 1) * m)
        c1 = dict(q=q0[sl], logp=lp[sl], grad=gr[sl], u=u0[sl])
        c1, o1, e1, g1 = meads._run(model.value_and_grad, c1, kernel, folds, 1.0, None,
                                    lambda i: (xs[i][sl], us[i][sl]))
        np.testing.assert_allclose(torch.stack(steps[w:], 1)[sl].numpy(), o1["q"].numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(eps[k].numpy(), e1[0].numpy(), rtol=1e-6)
        np.testing.assert_allclose(gamma[k].numpy(), g1[0].numpy(), rtol=1e-6)


def test_rep_batch():
    ir = post.normal_loc_scale_ir()
    kw = dict(num_warmup=100, num_samples=100, thin=5, seed=0, device="cpu")
    whole = tsbc.sbc(ir, num_replications=12, **kw)
    same = tsbc.sbc(ir, num_replications=12, rep_batch=12, **kw)
    for k in whole["ranks"]:
        np.testing.assert_array_equal(whole["ranks"][k], same["ranks"][k])
    assert whole["divergence_rate"] == same["divergence_rate"]
    # batches of 16, 16 and a padded 8
    batched = tsbc.sbc(ir, num_replications=40, rep_batch=16, **kw)
    assert batched["L"] == whole["L"] == 20 and batched["num_replications"] == 40
    assert all(len(r) == 40 for r in batched["ranks"].values())
    assert post.sbc_gate_failures(batched) == []


def test_argument_checks():
    ir = post.normal_loc_scale_ir()
    with pytest.raises(ValueError, match="unknown engine"):
        tsbc.sbc(ir, engine="hmc", device="cpu")
    with pytest.raises(ValueError, match="chees_chains"):
        tsbc.sbc(ir, engine="chees", chees_chains=1, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        tsbc.sbc(ir, engine="meads", chees_chains=6, device="cpu")
    with pytest.raises(TypeError, match="sampler options"):
        tsbc.sbc(ir, engine="chees", chees_chains=4, max_tree_depth=5, device="cpu")
    B = exmc_tpu_torch.Builder
    cens = B.obs(B.rv(B.new_ir(), "m", exmc_tpu_torch.dists.Normal,
                      {"mu": 0.0, "sigma": 1.0}), "m_obs", "m",
                 {"lower": np.float32(0.0), "upper": np.float32(1.0)})
    with pytest.raises(ValueError, match="interval-censored"):
        tsbc._obs_nodes(cens)
