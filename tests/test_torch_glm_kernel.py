"""The Bernoulli-logit GLM likelihood kernel (``ops.glm_logit``): which
IRs the compiler's structural test sends to it and which it leaves
alone, and its plain version against the compiled model's term and
autograd gradient, on the CPU; the kernel itself against the plain
version on the card (``-m gpu``)."""

import numpy as np
import pytest
import torch

import exmc_tpu_torch
from exmc_tpu_torch import Builder, NUTSSampler, compiler, dists
from exmc_tpu_torch.compiler import compile_logp, glm_logit_terms, partial_logp
from exmc_tpu_torch.glm import FAMILIES, LinearPredictor, glm
from exmc_tpu_torch.ops import glm_logit as op


def _data(n=60, p=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p))
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-x @ np.linspace(-1, 1, p)))).astype(float)
    return x, y


def _glm_ir(family="logistic", intercept=True, n=60, p=3):
    x, y = _data(n, p)
    with exmc_tpu_torch.Model() as m:
        glm(m, x, y, family=family, intercept=intercept)
    return m.ir


def _manual_ir(obs_meta=None, y_params=None, eta_fn=None):
    """beta (3,), beta_0, eta = x beta + beta_0 and y ~ Bernoulli(logits =
    eta) observed, each piece replaceable."""
    x, y = _data()
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "beta", dists.Normal, {"mu": 0.0, "sigma": 1.0}, shape=(3,))
    ir = Builder.rv(ir, "beta_0", dists.Normal, {"mu": 0.0, "sigma": 1.0})
    pred = LinearPredictor(x.astype(np.float32))
    ir = Builder.det(ir, "eta", eta_fn or pred, ["beta", "beta_0"])
    ir = Builder.det(ir, "p", "sigmoid", ["eta"])
    ir = Builder.rv(ir, "y", dists.Bernoulli, y_params or {"logits": "eta"}, shape=(60,))
    return Builder.obs(ir, "y_obs", "y", y, **(obs_meta or {}))


@pytest.mark.parametrize("intercept", [True, False])
def test_glm_logistic_engages_the_kernel(intercept):
    model = compile_logp(_glm_ir(intercept=intercept), device="cpu")
    terms = glm_logit_terms(model.ir)
    assert {k: v[1:] for k, v in terms.items()} == {
        "y_obs": ("beta", "beta_0" if intercept else None)}
    assert isinstance(terms["y_obs"][0], LinearPredictor)
    # on the CPU the value-and-grad keeps the eager form
    assert model.lik_kernel_terms == ()


NOT_ENGAGED = {
    "weight": lambda: _manual_ir(obs_meta={"weight": 2.0}),
    "mask": lambda: _manual_ir(obs_meta={"mask": np.arange(60) % 2 == 0}),
    "censored": lambda: _manual_ir(obs_meta={"censored": "right"}),
    "mean": lambda: _manual_ir(obs_meta={"reduce": "mean"}),
    "bernoulli_p": lambda: _manual_ir(y_params={"p": "p"}),
    "opaque_logits": lambda: _manual_ir(eta_fn=lambda b, b0: torch.as_tensor(
        _data()[0], dtype=b.dtype) @ b + b0),
    **{f"family_{f}": (lambda f=f: _glm_ir(family=f)) for f in FAMILIES if f != "logistic"},
}


@pytest.mark.parametrize("case", sorted(NOT_ENGAGED))
def test_other_irs_keep_their_path(case):
    assert glm_logit_terms(NOT_ENGAGED[case]()) == {}


def test_the_manual_ir_engages_and_pointwise_does_not():
    ir = _manual_ir()
    assert set(glm_logit_terms(ir)) == {"y_obs"}
    # pointwise terms are per row: the kernel's sum never stands in
    model = compile_logp(ir, device="cpu")
    graph = compiler._Graph(model.ir, model.pm, model.device, model.data)
    pw = compiler._make_logp(graph, model.pm, pointwise=True,
                             lik_kernel=glm_logit_terms(model.ir))
    flat = torch.zeros(2, model.size)
    assert pw(flat)["y_obs"].shape == (2, 60)


def _points(model, c=5, seed=1):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(-1.0, 1.0, size=(c, model.size)),
                           dtype=exmc_tpu_torch.config.default_dtype())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("intercept", [True, False])
def test_plain_version_equals_the_compiled_term(intercept, dtype):
    """The plain version's value and gradient against today's ``obs_term``
    and its autograd gradient: to float32 rounding (2e-5 of the terms'
    size, as the GLM's JAX parity), and to 1e-12 in float64."""
    with exmc_tpu_torch.config.x64(dtype == "float64"):
        ir = _glm_ir(intercept=intercept)
        model = compile_logp(ir, device="cpu")
        lik = partial_logp(model, "likelihood")
        flat = _points(model).requires_grad_(True)
        want = lik(flat)
        (want_g,) = torch.autograd.grad(want.sum(), flat)
        point = model.constrain(flat.detach())
        pred, coef, icpt = glm_logit_terms(model.ir)["y_obs"]
        x = torch.as_tensor(pred.x, dtype=flat.dtype)
        y = torch.as_tensor(_data()[1], dtype=flat.dtype)
        lp, g_beta, g_b0 = op.glm_logit_plain(x, y, point[coef],
                                               point[icpt] if icpt else None)
    got_g = {coef: g_beta, icpt: g_b0[:, None]} if icpt else {coef: g_beta}
    tol = 2e-5 if dtype == "float32" else 1e-12
    scale = float(want.detach().abs().max())
    assert float((lp - want.detach()).abs().max()) <= tol * scale
    for e in model.pm.entries:
        want_e = want_g[:, e.offset:e.offset + e.length]
        assert float((got_g[e.id] - want_e).abs().max()) <= tol * max(1.0, float(want_g.abs().max()))


def test_forced_dispatch_on_the_cpu_runs_the_plain_version(monkeypatch):
    """The compiler's path to the kernel, with the plain version standing
    in on the CPU: the value-and-grad equals the eager one, ``logp``
    keeps the eager form, and the sampler counts every call as the
    kernel's."""
    monkeypatch.setattr(compiler, "_lik_kernel", lambda ir, dev: glm_logit_terms(ir))
    ir = _glm_ir()
    kernel = compile_logp(ir, device="cpu")
    monkeypatch.undo()
    eager = compile_logp(ir, device="cpu")
    assert kernel.lik_kernel_terms == ("y_obs",) and eager.lik_kernel_terms == ()
    flat = _points(kernel)
    (lk, gk), (le, ge) = kernel.value_and_grad(flat), eager.value_and_grad(flat)
    torch.testing.assert_close(lk, le, rtol=2e-5, atol=1e-4)
    torch.testing.assert_close(gk, ge, rtol=2e-5, atol=1e-4)
    torch.testing.assert_close(kernel.logp(flat), eager.logp(flat), rtol=0, atol=0)
    for model, share in ((kernel, 1), (eager, 0)):
        smp = NUTSSampler(model=model, num_warmup=15, num_samples=10)
        _, stats = smp.run(num_chains=2, seed=3)
        assert stats["vag_calls_lik_kernel"] == share * sum(stats["vag_calls"].values())
        assert smp.last_run["vag_calls_lik_kernel"] == stats["vag_calls_lik_kernel"]


def test_the_autograd_function_is_once_differentiable():
    x, y = (torch.as_tensor(a, dtype=torch.float64) for a in _data())
    beta = torch.randn(4, 3, dtype=torch.float64, requires_grad=True)
    b0 = torch.randn(4, dtype=torch.float64, requires_grad=True)
    lp = op.glm_logit(x, y, beta, b0)
    g_beta, g_b0 = torch.autograd.grad((2.0 * lp).sum(), (beta, b0))
    want = op.glm_logit_plain(x, y, beta.detach(), b0.detach())
    torch.testing.assert_close(lp.detach(), want[0], rtol=0, atol=0)
    torch.testing.assert_close(g_beta, 2.0 * want[1], rtol=0, atol=0)
    torch.testing.assert_close(g_b0, 2.0 * want[2], rtol=0, atol=0)
    (gg,) = torch.autograd.grad(op.glm_logit(x, y, beta).sum(), beta, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gg.sum(), beta)


def test_the_wrapper_refuses_what_it_does_not_take():
    x, y = (torch.as_tensor(a, dtype=torch.float32) for a in _data())
    beta = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="expected"):
        op.glm_logit_value_and_grad(x, y, torch.zeros(2, 4))
    with pytest.raises(ValueError, match="b0"):
        op.glm_logit_value_and_grad(x, y, beta, torch.zeros(3))
    with pytest.raises(TypeError):
        op.glm_logit_value_and_grad(x, y, beta.double())
    with pytest.raises(ValueError, match="unsupported device"):
        op.glm_logit_value_and_grad(x.to("meta"), y.to("meta"), beta.to("meta"))


# ---------------------------------------------------------------------------
# on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _inputs(c, n, d, scale=0.2, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, d, generator=g, device="cuda")
    y = (torch.rand(n, generator=g, device="cuda") < 0.5).float()
    beta = torch.randn(c, d, generator=g, device="cuda") * scale
    b0 = torch.randn(c, generator=g, device="cuda") * scale
    return x, y, beta, b0


def _against_float64(x, y, beta, b0):
    """The kernel against the plain version in float64. Each sum of
    float32 products and terms is held to 1e-5 of the sum of the
    magnitudes it adds (float32's 6e-8 rounding, grown by summation
    depth): |lp - lp64| <= 1e-5 sum_i |term|, |g - g64| <= 1e-5 |r| @ |x|."""
    lp, g_beta, g_b0 = op.glm_logit_value_and_grad(x, y, beta, b0)
    x, y, beta = x.double(), y.double(), beta.double()
    b0 = None if b0 is None else b0.double()
    want = op.glm_logit_plain(x, y, beta, b0)
    eta = beta @ x.T + (0.0 if b0 is None else b0[:, None])
    terms = (y * eta - torch.logaddexp(torch.zeros_like(eta), eta)).abs().sum(-1)
    r = (y - torch.sigmoid(eta)).abs()
    assert torch.isfinite(lp).all() and torch.isfinite(g_beta).all()
    assert ((lp.double() - want[0]).abs() <= 1e-5 * terms).all()
    assert ((g_beta.double() - want[1]).abs() <= 1e-5 * (r @ x.abs()) + 1e-30).all()
    if b0 is not None:
        assert ((g_b0.double() - want[2]).abs() <= 1e-5 * r.sum(-1) + 1e-30).all()


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 7, 64, 1024])
@pytest.mark.parametrize("d", [1, 21, 54, 255])
def test_kernel_against_plain_on_card(c, d):
    _card()
    x, y, beta, b0 = _inputs(c, 10_007, d)  # N not a multiple of the tile
    _against_float64(x, y, beta, b0)
    _against_float64(x, y, beta, None)


@pytest.mark.gpu
def test_kernel_at_covertypes_shape_and_extreme_logits_on_card():
    _card()
    _against_float64(*_inputs(64, 581_012, 54))
    x, y, beta, b0 = _inputs(64, 20_011, 54, scale=20.0)
    assert float((beta @ x.T).abs().median()) >= 40.0
    _against_float64(x, y, beta, b0)


@pytest.mark.gpu
def test_kernel_repeats_bit_for_bit_and_refuses_on_card():
    _card()
    x, y, beta, b0 = _inputs(64, 581_012, 54)
    a = op.glm_logit_value_and_grad(x, y, beta, b0)
    b = op.glm_logit_value_and_grad(x, y, beta, b0)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    with pytest.raises(TypeError, match="float32"):
        op.glm_logit_value_and_grad(x.double(), y.double(), beta.double(), b0.double())
    with pytest.raises(ValueError, match="columns"):
        x2 = torch.zeros(10, op.max_d() + 1, device="cuda")
        op.glm_logit_value_and_grad(x2, y[:10], torch.zeros(2, op.max_d() + 1, device="cuda"))
    with pytest.raises(ValueError, match="expected"):
        op.glm_logit_value_and_grad(x, y[:-1], beta, b0)


@pytest.mark.gpu
def test_graphed_model_and_resumed_run_on_card(tmp_path):
    """The model's CUDA graph replays the eager call bit for bit, and a
    chunked run resumed from its checkpoint equals the whole run."""
    dev = _card()
    x, y = _data(n=20_000, p=21, seed=5)
    with exmc_tpu_torch.Model() as m:
        glm(m, x, y, family="logistic")
    model = compile_logp(m.ir, device=dev)
    assert model.lik_kernel_terms == ("y_obs",)
    flat = _points(model, c=64).to(dev) * 0.1
    got, eager = model.value_and_grad(flat), model.value_and_grad.eager(flat, None)
    assert torch.equal(got[0], eager[0]) and torch.equal(got[1], eager[1])

    from exmc_tpu_torch.benchmarks.entry import _same_run

    smp = NUTSSampler(model=model, num_warmup=60, num_samples=40)
    base = smp.run(num_chains=64, seed=3)
    assert base[1]["vag_calls_lik_kernel"] == sum(base[1]["vag_calls"].values()) > 0
    ckpt, first = tmp_path / "ckpt.npz", tmp_path / "first.npz"

    def keep_first(start, trace, stats):
        if not first.exists():
            first.write_bytes(ckpt.read_bytes())

    smp.run_chunked(num_chains=64, seed=3, chunk_iters=37, checkpoint_path=str(ckpt),
                    callback=keep_first)
    resumed = smp.run_chunked(num_chains=64, seed=3, chunk_iters=37, resume_from=str(first))
    assert _same_run(base, resumed)
