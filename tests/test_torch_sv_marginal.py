"""The Laplace marginal's own precision and its counters, and the
``sv_marginal`` benchmark configuration, on the CPU at small sizes
(T <= 128, at most 3 points): the float64 marginal under a float32
process against the plain reference ``h100_bench/reference/sv_marginal.py``
and against the same marginal under ``config.x64()``; ``dtype=None``
unchanged; the counters, alone and through a NUTS run's
``stats["laplace"]``; the configuration's ``build`` through
``exmc_tpu_torch.sample``. The card's case (the graphed float64 marginal
against its eager call, counters included) is marked ``gpu``."""

import ast
import importlib.util
import json
import math
import pathlib

import numpy as np
import pytest
import torch

import exmc_tpu_torch
from exmc_tpu_torch import Builder, config, dists
from exmc_tpu_torch.benchmarks.suite import sv_model
from exmc_tpu_torch import marginal as marginal_module
from exmc_tpu_torch.marginal import _sv_loglik, make_grw_marginal, sv_marginal_model
from exmc_tpu_torch.utils import profiling

BENCH = pathlib.Path(__file__).resolve().parents[1] / "h100_bench"
T = 128
SIGMA = [0.02, 0.06, 0.15]
NU = [4.0, 10.0, 30.0]
# the float64 marginal against the reference, in nats: both converge the
# mode to rounding (they agree to ~1e-12); the float32 marginal misses
# by ~1e-4 here
LOGZ_TOL = 1e-7
# the gradient in (log sigma, log nu), relative: the reference's central
# differences agree to ~1e-9, and the port's implicit backward, which
# holds the floored curvature W fixed, to ~5e-7
GRAD_RTOL = 1e-5


def _load(rel):
    path = BENCH / rel
    spec = importlib.util.spec_from_file_location("sv_" + path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _load("reference/sv_marginal.py")


@pytest.fixture(scope="module")
def returns():
    return np.asarray(sv_model(t=T, seed=5).nodes["r_obs"].op[2], np.float64)


def _points(dtype, grad=False):
    sig = torch.tensor(SIGMA, dtype=dtype, requires_grad=grad)
    nu = torch.tensor(NU, dtype=dtype, requires_grad=grad)
    return sig, nu


def _logz_and_grad(marginal, sig, nu):
    log_z, s_hat, var = marginal(sig, {"nu": nu})
    grads = torch.autograd.grad(log_z.sum(), [sig, nu])
    return log_z, s_hat, var, grads


def test_float64_marginal_against_the_reference(returns):
    m64 = make_grw_marginal(_sv_loglik(returns), T, newton_iters=25, dtype=torch.float64)
    sig, nu = _points(torch.float64, grad=True)
    log_z, _, _, (g_sig, g_nu) = _logz_and_grad(m64, sig, nu)
    assert log_z.dtype == torch.float64 and config.default_dtype() == torch.float32
    ref_z, _ = REF._log_z(REF._Points(returns, SIGMA, NU, torch.float64, "cpu"))
    assert np.abs(log_z.detach().numpy() - ref_z.numpy()).max() < LOGZ_TOL
    # the reference's gradient of the whole log-density, less its priors'
    u = {"sigma": np.log(SIGMA), "nu": np.log(NU)}
    _, g_ref = REF.logp_and_grad(u, {"r": returns}, {}, "float64", "cpu")
    d_ls = g_ref["sigma"] - (1.0 - REF.SIGMA_RATE * np.asarray(SIGMA))
    d_ln = g_ref["nu"] - (1.0 - REF.NU_RATE * np.asarray(NU))
    mine = np.stack([g_sig.numpy() * SIGMA, g_nu.numpy() * NU])
    theirs = np.stack([d_ls, d_ln])
    assert np.abs(mine - theirs).max() < GRAD_RTOL * np.abs(theirs).max()

    # the float32 marginal misses the tolerance
    m32 = make_grw_marginal(_sv_loglik(returns), T, newton_iters=25)
    log_z32, _, _ = m32(*_points(torch.float32)[:1], {"nu": _points(torch.float32)[1]})
    assert log_z32.dtype == torch.float32
    assert np.abs(log_z32.double().numpy() - ref_z.numpy()).max() > 10 * LOGZ_TOL


def test_the_sv_likelihoods_own_derivatives_equal_nested_autograd(returns):
    loglik = _sv_loglik(returns)
    s = torch.linspace(-40.0, 40.0, T, dtype=torch.float64).expand(3, T)
    s = torch.where(torch.arange(T) % 2 == 0, s, 0.1 * s)
    theta = {"nu": torch.tensor(NU, dtype=torch.float64).unsqueeze(-1)}

    def g1_sum(x):
        g = torch.func.grad(lambda y: loglik(y, theta).sum())(x)
        return g.sum(), g

    want2, want1 = torch.func.grad(g1_sum, has_aux=True)(s)
    got1, got2 = loglik.derivs(s, theta)
    assert torch.allclose(got1, want1, rtol=1e-12, atol=1e-12)
    assert torch.allclose(got2, want2, rtol=1e-10, atol=1e-12)


def test_float64_under_float32_equals_the_x64_marginal(returns):
    m64 = make_grw_marginal(_sv_loglik(returns), T, newton_iters=15, dtype=torch.float64)
    mine = _logz_and_grad(m64, *_points(torch.float64, grad=True))
    with config.x64():
        mx = make_grw_marginal(_sv_loglik(returns), T, newton_iters=15)
        theirs = _logz_and_grad(mx, *_points(torch.float64, grad=True))
    for a, b in zip(mine[:3] + mine[3], theirs[:3] + theirs[3]):
        assert a.dtype == torch.float64 and torch.equal(a, b)
    # float32 inputs: the float64 computation, handed back in float32
    sig, nu = _points(torch.float32, grad=True)
    log_z, s_hat, var, grads = _logz_and_grad(m64, sig, nu)
    assert log_z.dtype == s_hat.dtype == var.dtype == grads[0].dtype == torch.float32
    assert torch.equal(log_z, theirs[0].float())


def test_dtype_none_keeps_the_default_dtype(returns):
    base = make_grw_marginal(_sv_loglik(returns), T, newton_iters=15)
    f32 = make_grw_marginal(_sv_loglik(returns), T, newton_iters=15, dtype=torch.float32)
    a = _logz_and_grad(base, *_points(torch.float32, grad=True))
    b = _logz_and_grad(f32, *_points(torch.float32, grad=True))
    for x, y in zip(a[:3] + a[3], b[:3] + b[3]):
        assert x.dtype == torch.float32 and torch.equal(x, y)
    # float64 inputs are cast to the default, as before the argument
    log_z, _, _ = base(*_points(torch.float64)[:1], {"nu": _points(torch.float64)[1]})
    assert log_z.dtype == torch.float32 and torch.equal(log_z, a[0].detach())


def test_counters_of_one_call(returns):
    def read(marginal, iters_run, sig, nu):
        marginal.counters.reset()
        marginal(sig, {"nu": nu})
        out = marginal.counters.read()
        assert out["calls"] == 1 and out["newton_iters"] == iters_run
        assert 0 <= out["live_iters"] <= iters_run
        return out

    loglik = _sv_loglik(returns)
    m64 = make_grw_marginal(loglik, T, newton_iters=25, dtype=torch.float64)
    converged = read(m64, 25, *_points(torch.float64))
    assert converged["live_iters"] < 25 and converged["mode_residual_p99"] < 1e-9
    m32 = make_grw_marginal(loglik, T, newton_iters=25)
    assert read(m32, 25, *_points(torch.float32))["mode_residual_p99"] > 1e-7
    short = read(make_grw_marginal(loglik, T, newton_iters=2, dtype=torch.float64), 2,
                 *_points(torch.float64))
    assert short["live_iters"] == 2 and short["mode_residual_p99"] > 1e-3
    # the percentile is the upper edge of a quarter-decade bin
    e = 4.0 * math.log10(short["mode_residual_p99"])
    assert abs(e - round(e)) < 1e-9
    # a call under a torch.func transform counts nothing
    unrolled = make_grw_marginal(loglik, T, newton_iters=2, implicit_diff=False,
                                 dtype=torch.float64)
    unrolled.counters.reset()
    torch.func.grad(lambda s: unrolled(s, {"nu": _points(torch.float64)[1]})[0].sum())(
        _points(torch.float64)[0])
    assert unrolled.counters.read()["calls"] == 0


def test_max_step_finds_the_mode_where_the_unbounded_step_stalls(monkeypatch):
    """Returns far below exp(0) (the mode near s = -4 at T = 256): the
    floored curvature's full step overshoots, every backtracking try is
    refused and an unbounded Newton stays at s = 0; bounded at
    ``MAX_STEP``, it finds the mode."""
    r = np.asarray(sv_model(t=256, seed=5).nodes["r_obs"].op[2], np.float64) * math.exp(-4.0)
    ref_z, _ = REF._log_z(REF._Points(r, SIGMA, NU, torch.float64, "cpu"))

    def miss():
        m = make_grw_marginal(_sv_loglik(r), 256, newton_iters=15, dtype=torch.float64)
        log_z, _, _ = m(*_points(torch.float64)[:1], {"nu": _points(torch.float64)[1]})
        return (np.abs(log_z.numpy() - ref_z.numpy()).max(),
                m.counters.read()["mode_residual_p99"])

    bounded = miss()
    monkeypatch.setattr(marginal_module, "MAX_STEP", math.inf)
    unbounded = miss()
    assert unbounded[0] > 100.0 and unbounded[1] > 0.1
    assert bounded[0] < LOGZ_TOL and bounded[1] < 1e-8


def test_the_configuration_runs_a_short_fit_through_sample():
    config_module = _load("configs/sv_marginal.py")
    cfg = json.loads((BENCH / "configs" / "sv_marginal.json").read_text())
    cfg.update(T=32, newton_iters=4)
    ir, data = config_module.build(cfg, 2**31 + 5, "cpu")
    assert data["r"].shape == (32,) and data["r"].dtype == np.float64
    with profiling.tracing(True):
        trace, stats = exmc_tpu_torch.sample(ir, num_chains=2, num_warmup=10, num_samples=6,
                                             seed=3, device="cpu")
    assert trace["sigma"].dtype == np.float32 and np.isfinite(trace["sigma"]).all()
    lap = stats["laplace"]
    calls = sum(stats["vag_calls"].values())
    assert lap["calls"] == calls and lap["newton_iters"] == 4 * calls
    assert 0 < lap["live_iters"] <= lap["newton_iters"]
    assert 0.0 < lap["mode_residual_p99"] <= 100.0
    # the cached sampler that sample() ran
    sampler = exmc_tpu_torch.nuts.sampler._make_sampler(ir, device="cpu", num_warmup=10,
                                                         num_samples=6)
    assert len(sampler.model.counters) == 1
    # the non-centring rewrite has nothing to change here, so the
    # sampler's default ncp=True runs the model as written
    assert sampler.model.ncp_info == {}
    spans = sampler.last_run["spans"]
    assert spans["exmc.laplace.newton"]["count"] == calls
    assert spans["exmc.laplace.backward"]["count"] == calls
    assert spans["exmc.vag"]["count"] == calls
    assert spans["exmc.tree"]["self_s"] >= 0.0 and spans["exmc.vag"]["self_s"] >= 0.0


def test_a_model_without_a_marginal_has_no_counters():
    ir = Builder.rv(Builder.new_ir(), "mu", dists.Normal, {"mu": 0.0, "sigma": 1.0})
    ir = Builder.rv(ir, "y", dists.Normal, {"mu": "mu", "sigma": 1.0})
    ir = Builder.obs(ir, "y_obs", "y", 0.5)
    assert exmc_tpu_torch.compile_logp(ir, device="cpu").counters == ()
    _, stats = exmc_tpu_torch.sample(ir, num_chains=2, num_warmup=5, num_samples=5, seed=0,
                                     device="cpu")
    assert "laplace" not in stats


def test_the_reference_imports_nothing_of_the_port():
    tree = ast.parse((BENCH / "reference" / "sv_marginal.py").read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"math", "numpy", "torch"}, names


@pytest.mark.gpu
def test_graphed_float64_marginal_equals_its_eager_call_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = np.asarray(sv_model(t=1000, seed=7).nodes["r_obs"].op[2], np.float64)
    model = exmc_tpu_torch.compile_logp(
        sv_marginal_model(r, newton_iters=15, dtype=torch.float64),
        device="cuda")
    gen = torch.Generator().manual_seed(0)
    x = (torch.tensor([math.log(10.0), math.log(0.03)])
         + 0.3 * torch.randn(16, 2, generator=gen)).cuda()
    model.value_and_grad(x)                          # captures the graph

    def counted(call):
        model.counters[0].reset()
        out = call()
        return out, model.counters[0].read()

    (lg, gg), graphed = counted(lambda: model.value_and_grad(x))
    (le, ge), eager = counted(lambda: model.value_and_grad.eager(x, None))
    assert len(model.value_and_grad.graphs) == 1
    assert lg.dtype == gg.dtype == torch.float32
    assert torch.equal(lg, le) and torch.equal(gg, ge), ((lg - le).abs().max().item(),
                                                         (gg - ge).abs().max().item())
    assert graphed == eager, (graphed, eager)
    assert graphed["calls"] == 1 and graphed["newton_iters"] == 15, graphed
    assert graphed["mode_residual_p99"] < 1e-6, graphed
