"""Normalizing flows and NeuTra in the port against the JAX package on
the CPU, the JAX flow's parameters carried across by
``interop.flow_from_numpy``:

* forward, inverse and log-determinant of a bent flow (1e-5), the
  parameter round trip, the identity at init;
* ``flow_fit`` from JAX's initial parameters with JAX's training normals
  (the key discipline of ``exmc_tpu/flows.py``): the parameters and
  the ELBO history after a few Adam steps (1e-4 relative), also on a
  model whose log-density is NaN for part of every batch (the double
  where keeps each step finite);
* ``sample_neutra``'s z-space value-and-grad against JAX's
  logp(f(z)) + logdet at points (1e-5 relative);
* the argument checks of ``tests/test_flows.py`` and the evidence API.

Run as a script, it gives the JAX package's side of
``python -m exmc_tpu_torch.benchmarks.post --neutra-grid``: the centered
funnel's NeuTra gates over (flow seed, NUTS seed) pairs (default 1..8 x
0..2) on the CPU, judged by the port's ``post.funnel_gate_failures``,
one JSON line a pair:

    PYTHONPATH=. python tests/test_torch_flows.py [--flow-seeds ...] [--nuts-seeds ...]
        [--save-flows flows.npz]

``--save-flows`` keeps the trained flows for the port's
``python -m exmc_tpu_torch.benchmarks.post --neutra-grid --flows flows.npz``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import exmc_tpu
import exmc_tpu_torch
from exmc_tpu import flows as jflows
from exmc_tpu.compiler import compile_logp as jcompile
from exmc_tpu_torch import flows as tflows
from exmc_tpu_torch.compiler import compile_logp as tcompile
from exmc_tpu_torch.interop import flow_from_numpy, flow_to_numpy
from exmc_tpu_torch.model_comparison import log_marginal_likelihood

RTOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bent(d=5, layers=4, hidden=16):
    key = jax.random.PRNGKey(0)
    params = jflows.init_flow(key, d, num_layers=layers, hidden=hidden)
    for k in range(layers):
        params["layers"][k]["w2"] = 0.3 * jax.random.normal(
            jax.random.fold_in(key, 10 + k), params["layers"][k]["w2"].shape)
        params["layers"][k]["b2"] = 0.2 * jax.random.normal(
            jax.random.fold_in(key, 20 + k), params["layers"][k]["b2"].shape)
    params["mu"] = jnp.linspace(-1, 1, d)
    return params


def test_forward_inverse_logdet_equal_jax():
    params = _bent()
    flow = flow_from_numpy(_np(params), device="cpu")
    z = np.random.default_rng(1).normal(size=(7, 5)).astype(np.float32)
    jx, jld = jax.vmap(lambda zz: jflows.flow_forward(params, zz))(jnp.asarray(z))
    x, ld = tflows.flow_forward(flow, torch.as_tensor(z))
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(jld), rtol=RTOL, atol=1e-6)
    jz, jild = jax.vmap(lambda xx: jflows.flow_inverse(params, xx))(jx)
    z2, ild = tflows.flow_inverse(flow, x)
    np.testing.assert_allclose(z2.detach().numpy(), np.asarray(jz), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(ild.detach().numpy(), np.asarray(jild), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(z2.detach().numpy(), z, atol=1e-5)
    back = flow_to_numpy(flow)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(_np(params))):
        np.testing.assert_array_equal(a, b)


def test_identity_at_init():
    flow = tflows.init_flow(3, num_layers=4, seed=1, device="cpu")
    z = torch.tensor([[0.3, -1.2, 2.0], [1.0, 0.0, -0.5]])
    x, ld = flow(z)
    np.testing.assert_allclose(x.detach().numpy(),
                               (flow.mu + torch.exp(flow.log_s) * z).detach().numpy())
    np.testing.assert_allclose(ld.detach().numpy(), [float(flow.log_s.sum().detach())] * 2)


def conjugate(pkg):
    y = np.random.default_rng(5).normal(2.0, 1.0, 30)
    B, D = pkg.Builder, pkg.dists
    ir = B.rv(B.new_ir(), "mu", D.Normal, {"mu": 0.0, "sigma": 3.0})
    ir = B.rv(ir, "sig", D.HalfNormal, {"sigma": 2.0})
    ir = B.rv(ir, "y", D.Normal, {"mu": "mu", "sigma": "sig"})
    return B.obs(ir, "y_obs", "y", y)


def cliff(pkg, log):
    """x ~ N(0, 1) plus log(0.4 - x): NaN for x > 0.4, about a third of
    the flow's draws at init."""
    B, D = pkg.Builder, pkg.dists
    ir = B.rv(B.new_ir(), "x", D.Normal, {"mu": 0.0, "sigma": 1.0}, shape=(2,))
    ir = B.det(ir, "c", lambda x: log(0.4 - x), ["x"])
    ir = B.rv(ir, "f", D.Normal, {"mu": "c", "sigma": 1.0}, shape=(2,))
    return B.obs(ir, "f_obs", "f", np.zeros(2, np.float32))


@pytest.mark.parametrize("name", ["conjugate", "cliff"])
def test_flow_fit_steps_from_jax_state(name):
    jir, tir = ((conjugate(exmc_tpu), conjugate(exmc_tpu_torch)) if name == "conjugate"
                else (cliff(exmc_tpu, jnp.log), cliff(exmc_tpu_torch, torch.log)))
    iters, draws, seed, kw = 6, 8, 3, dict(num_layers=2, hidden=8, lr=5e-3)
    want = jflows.flow_fit(jir, num_iters=iters, num_elbo_draws=draws, seed=seed, **kw)
    d = want.model.size
    key, init_key = jax.random.split(jax.random.PRNGKey(seed))
    init = jflows.init_flow(init_key, d, num_layers=2, hidden=8)
    zs = []
    for _ in range(iters):
        key, kz = jax.random.split(key)
        zs.append(np.asarray(jax.random.normal(kz, (draws, d), jnp.float32)))
    got = tflows.flow_fit(tir, num_iters=iters, num_elbo_draws=draws, device="cpu",
                          init=flow_from_numpy(_np(init), device="cpu"),
                          noise=np.stack(zs), **kw)
    np.testing.assert_allclose(got.elbo_history, want.elbo_history, rtol=1e-4, atol=1e-4)
    assert np.isfinite(got.elbo_history).all()
    for a, b in zip(jax.tree_util.tree_leaves(flow_to_numpy(got.flow)),
                    jax.tree_util.tree_leaves(_np(want.params))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_neutra_value_and_grad_equals_jax():
    params = _bent(d=2, layers=3, hidden=8)
    jm = jcompile(conjugate(exmc_tpu))
    fit = tflows.FlowFit(model=tcompile(conjugate(exmc_tpu_torch), device="cpu"),
                         flow=flow_from_numpy(_np(params), device="cpu"),
                         elbo_history=np.zeros(1))
    zmodel = tflows.neutra_model(fit)
    assert tflows.neutra_model(fit) is zmodel  # cached on the fit
    z = np.random.default_rng(2).normal(size=(5, 2)).astype(np.float32)
    lp, g = zmodel.value_and_grad(torch.as_tensor(z))

    def logp_z(zz):
        x, ld = jflows.flow_forward(params, zz)
        return jm.logp(x) + ld

    for i in range(5):
        want, want_g = jax.value_and_grad(logp_z)(jnp.asarray(z[i]))
        np.testing.assert_allclose(float(lp[i]), float(want), rtol=RTOL)
        np.testing.assert_allclose(g[i].numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-5)
    assert not any(p.requires_grad for p in zmodel.flow.parameters())


def test_argument_checks():
    ir = conjugate(exmc_tpu_torch)
    fit = tflows.flow_fit(ir, num_iters=3, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        tflows.sample_neutra(ir, flow=fit, flow_kwargs={"num_iters": 5})
    with pytest.raises(ValueError, match="not both"):
        log_marginal_likelihood(ir, method="flow", flow=fit, num_iters=3, device="cpu")
    with pytest.raises(ValueError, match="method"):
        log_marginal_likelihood(ir, method="bridge", device="cpu")
    empty = exmc_tpu_torch.Builder.new_ir()
    with pytest.raises(ValueError, match="no free parameters"):
        tflows.flow_fit(empty, num_iters=3, device="cpu")
    trace, stats = tflows.sample_neutra(ir, flow=fit, num_chains=2, num_warmup=20,
                                        num_samples=10, seed=0)
    assert trace["mu"].shape == (2, 10) and (trace["sig"] > 0).all()
    x, _ = tflows.sample_neutra(ir, flow=fit, num_chains=2, num_warmup=5, num_samples=4,
                                return_unconstrained=True)
    assert x.shape == (2, 4, 2)


def jax_neutra_grid(flow_seeds=range(1, 9), nuts_seeds=range(3), saved=None):
    """The JAX package's flows on the funnel of
    ``tests/test_flows.py::test_neutra_centered_funnel``, one per flow
    seed, each sampled at every NUTS seed: for each flow a dict of its
    fit (the ELBO of its last 100 steps, the Pareto k-hat of 2000
    draws), then one dict per pair. ``saved`` (a dict) gets each flow's
    parameters and ELBO history under ``post.load_flows``'s keys."""
    from exmc_tpu_torch.benchmarks import post

    def funnel():
        with exmc_tpu.Model() as m:
            m.rv("y", exmc_tpu.dists.Normal, {"mu": 0.0, "sigma": 3.0})
            m.det("sc", lambda y: jnp.exp(y / 2), ["y"])
            m.rv("x", exmc_tpu.dists.Normal, {"mu": np.zeros(4), "sigma": "sc"},
                 shape=(4,))
        return m.ir

    rows = []
    for fs in flow_seeds:
        fit = jflows.flow_fit(funnel(), ncp=False, num_iters=4000, num_elbo_draws=32,
                              num_layers=6, lr=3e-3, seed=fs)
        if saved is not None:
            p = _np(fit.params)
            saved.update({f"{fs}/mu": p["mu"], f"{fs}/log_s": p["log_s"],
                          f"{fs}/elbo_history": np.asarray(fit.elbo_history)})
            saved.update({f"{fs}/layers/{i}/{w}": v for i, lay in enumerate(p["layers"])
                          for w, v in lay.items()})
        rows.append(dict(check="neutra_flow", flow_seed=fs,
                         elbo=float(np.mean(fit.elbo_history[-100:])),
                         pareto_k=float(fit.psis_diagnostic(num_draws=2000))))
        for ns in nuts_seeds:
            trace, stats = jflows.sample_neutra(funnel(), flow=fit, ncp=False,
                                                num_chains=4, num_warmup=500,
                                                num_samples=1500, seed=ns,
                                                target_accept=0.9)
            y, x0 = np.asarray(trace["y"]), np.asarray(trace["x"])[..., 0]
            div = float(np.sum(stats["divergences"]))
            fails = post.funnel_gate_failures(y, x0, div)
            rows.append(dict(check="neutra_grid", flow_seed=fs, nuts_seed=ns,
                             rhat_y=float(post.rhat(y)), ess_y=float(post.ess(y)),
                             divergence_rate=div / y.size,
                             chain_divergences=np.asarray(stats["divergences"]).tolist(),
                             ok=not fails, failures=fails))
    return rows


if __name__ == "__main__":
    import argparse
    import json

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(description=jax_neutra_grid.__doc__)
    ap.add_argument("--flow-seeds", type=int, nargs="+", default=list(range(1, 9)))
    ap.add_argument("--nuts-seeds", type=int, nargs="*", default=list(range(3)))
    ap.add_argument("--save-flows", help="save the flows for the port's "
                                         "post --neutra-grid --flows (npz)")
    args = ap.parse_args()
    pairs, saved = [], {}
    for fs in args.flow_seeds:  # a line as each flow's pairs end
        for row in jax_neutra_grid([fs], args.nuts_seeds, saved):
            pairs += [row] if row["check"] == "neutra_grid" else []
            print(json.dumps(row), flush=True)
    if args.save_flows:
        np.savez(args.save_flows, **saved)
    print(json.dumps({"neutra_grid_pairs": len(pairs),
                      "failed": sum(not r["ok"] for r in pairs)}), flush=True)
