"""Each reference's log-density and gradient against the port's at
seeded points, at a small size on the CPU, with the port in float64;
each reference's inversion of the constrained draws; and its posterior."""

import math

import numpy as np
import pytest
import torch

from h100_bench import harness
from smallsizes import small_spec

CELLS = ["eight_schools.nuts", "covtype_logistic.nuts"]


def _program_and_reference(cell, seed=11):
    import exmc_tpu_torch
    from exmc_tpu_torch import config

    spec = small_spec(cell)
    builder = harness.load_module(spec.cfg_path.with_suffix(".py"))
    ref = harness.load_module(harness.HERE / "reference" / f"{spec.cell['config']}.py")
    ir, data = builder.build(spec.cfg, seed, "cpu")
    with config.x64():
        model = exmc_tpu_torch.compile_logp(ir, device="cpu")
    return spec, model, ref, data


@pytest.mark.parametrize("cell", CELLS)
def test_logp_and_grad_equal_the_ports(cell):
    from exmc_tpu_torch import config

    spec, model, ref, data = _program_and_reference(cell)
    gen = torch.Generator().manual_seed(5)
    flat = (torch.rand(32, model.size, generator=gen, dtype=torch.float64) - 0.5) * 2.0
    with config.x64():
        lp, g = model.value_and_grad(flat)
    u = {e.id: flat[:, e.offset:e.offset + e.length].reshape((32,) + e.ushape).numpy()
         for e in model.pm.entries}
    lp_ref, g_ref = ref.logp_and_grad(u, data, spec.cfg, "float64", "cpu")
    assert np.allclose(lp.numpy(), lp_ref, rtol=1e-12, atol=1e-9)
    g_flat = np.concatenate([g_ref[e.id].reshape(32, -1) for e in model.pm.entries], 1)
    assert np.allclose(g.numpy(), g_flat, rtol=1e-10, atol=1e-9)


@pytest.mark.parametrize("cell", CELLS)
def test_unconstrain_inverts_the_ports_constraining(cell):
    from exmc_tpu_torch import config

    spec, model, ref, data = _program_and_reference(cell)
    gen = torch.Generator().manual_seed(6)
    flat = torch.randn(20, model.size, generator=gen, dtype=torch.float64)
    with config.x64():
        trace = {k: v.numpy()[None] for k, v in model.constrain(flat).items()}
    u = ref.unconstrain(trace, data, spec.cfg)
    back = np.concatenate([np.asarray(u[e.id])[0].reshape(20, -1) for e in model.pm.entries], 1)
    assert np.allclose(back, flat.numpy(), rtol=1e-10, atol=1e-10)


def test_rounding_allowance_covers_reported_draws_near_tau_zero():
    """The port's float32 log-density at points down to tau = e^-16,
    against the reference at the float32 draws it reports: the gap grows
    as 1 / tau (up to 16 nats here), and the allowance covers it."""
    import exmc_tpu_torch

    spec = small_spec("eight_schools.nuts")
    builder = harness.load_module(spec.cfg_path.with_suffix(".py"))
    ref = harness.load_module(harness.HERE / "reference" / "eight_schools.py")
    ir, data = builder.build(spec.cfg, 1, "cpu")
    model = exmc_tpu_torch.compile_logp(ir, device="cpu")
    gen = torch.Generator().manual_seed(0)
    gaps = []
    for log_tau in (-2.0, -6.0, -9.0, -12.0, -14.0, -16.0):
        q = torch.randn(500, model.size, generator=gen)
        q[:, 0] = 4.4 + 3.0 * q[:, 0]
        q[:, 1] = log_tau
        lp, _ = model.value_and_grad(q)
        x = {k: v.numpy() for k, v in model.constrain(q).items()}
        lp_ref, g_ref = ref.logp_and_grad(ref.unconstrain(x, data, spec.cfg), data, spec.cfg)
        gap = np.abs(lp.double().numpy() - lp_ref)
        gaps.append(gap.max())
        over = gap - ref.rounding_allowance(x, g_ref, data, spec.cfg, 2.0**-24)
        assert over.max() < 1e-4, (log_tau, over.max())
    assert gaps[0] < 1e-4 and gaps[-1] > 1.0


def test_eight_schools_posterior_by_quadrature():
    spec, _, ref, data = _program_and_reference("eight_schools.nuts")
    post = ref.posterior(data, spec.cfg)
    # the published posterior of the non-centred model (posteriordb's
    # reference draws): mu 4.4 (sd 3.3), tau 3.6 (sd 3.2)
    assert abs(float(post["mu"][0]) - 4.4) < 0.1 and abs(float(post["mu"][1]) - 3.3) < 0.1
    assert abs(float(post["tau"][0]) - 3.6) < 0.1 and abs(float(post["tau"][1]) - 3.2) < 0.15


def test_covtype_posterior_against_quadrature():
    """One column and the intercept: the importance-sampled moments
    against the trapezoid rule on a fine grid of the two coefficients."""
    from h100_bench.reference import covtype_logistic as ref

    rng = np.random.default_rng(4)
    x = rng.standard_normal((3000, 1)).astype(np.float32)
    y = (rng.random(3000) < 1.0 / (1.0 + np.exp(-(0.8 * x[:, 0] + 0.3)))).astype(np.float32)
    data = {"X": x, "y": y}
    post = ref.posterior(data, {}, seed=3, device="cpu")
    mode, h = ref._mode(ref._Data(data, "cpu", torch.float64))
    sd = torch.sqrt(torch.diag(torch.linalg.inv(h))).numpy()
    grid = [np.linspace(m - 8 * s, m + 8 * s, 401) for m, s in zip(mode.numpy(), sd)]
    b, b0 = np.meshgrid(*grid, indexing="ij")
    lp, _ = ref.logp_and_grad({"beta": b.reshape(-1, 1), "beta_0": b0.reshape(-1)},
                              data, {}, "float64", "cpu")
    w = np.exp(lp - lp.max())
    w /= w.sum()
    for v, (m, s, _) in ((b.reshape(-1), post["beta"]), (b0.reshape(-1), post["beta_0"])):
        mean = (w * v).sum()
        sdq = math.sqrt((w * (v - mean) ** 2).sum())
        assert abs(float(np.ravel(m)[0]) - mean) < 0.02 * sdq
        assert abs(float(np.ravel(s)[0]) / sdq - 1.0) < 0.02


def test_tf32_rounding():
    from h100_bench.reference import covtype_logistic as ref

    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -(1.0 + 2.0**-10), 3.0e-3])
    r = ref._tf32(x)
    assert r[0] == 1.0 and r[3] == -(1.0 + 2.0**-10)
    assert r[1] == 1.0 + 2.0**-10 and r[2] == 1.0 + 2.0**-9
    assert math.isclose(float(r[4]), 3.0e-3, rel_tol=2.0**-11)
