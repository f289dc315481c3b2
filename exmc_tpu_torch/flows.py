"""Normalizing-flow VI (affine coupling, RealNVP) and NeuTra-HMC
(``exmc_tpu/flows.py``).

``flow_fit`` trains a coupling flow q = f # N(0, I) on the model's
compiled unconstrained log-density by reparameterized ELBO ascent,
E_z[logp(f(z)) + log|det J_f(z)|] + H(base). The flow
(``CouplingFlow``, an ``nn.Module``) is a learned diagonal base affine
then ``num_layers`` affine-coupling layers, each a one-hidden-layer tanh
MLP conditioner whose log-scales are soft-clamped to +-``_LOGS_MAX``; the
conditioner's output layer starts at zero, so the flow is the base
affine at init. Its products are plain ``torch.matmul``, as the JAX
package computes them outside any Pallas kernel.

Training uses ``advi.py``'s clip-by-global-norm (10) and Adam, and
rejects a step whose loss or new parameters are not finite together with
its optimizer state. The ELBO masks non-finite draws with the JAX
package's double where: a probe of logp at the detached points finds
them, and the gradient path evaluates logp only at sanitized points (a
single mask after the fact keeps the loss finite, but 0 * NaN = NaN in
the backward pass would reject every step). The gradient flows through
``model.logp`` to the flow's parameters, so training runs the eager
log-density; the steps run as a host loop with no host read.

``sample_neutra`` runs NUTS on the pulled-back density pi(f(z)) |det J|
in z space, then pushes the draws through f: exact MCMC whatever the
flow's quality. Its z-space model replays a CUDA graph of
logp(f(z)) + logdet and its gradient in z (``GraphedValueAndGrad``),
with the trained parameters frozen, and is cached on the ``FlowFit``.

Randomness: the init weights, the training normals (num_iters,
num_elbo_draws, d) and the draws of ``sample`` come from
``torch.Generator``s seeded from ``seed``, or are injected (``noise=``,
``z=``).
"""

import copy
import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch import nn

from exmc_tpu_torch.advi import _adam, _clip_by_global_norm, _select
from exmc_tpu_torch.compiler import (
    CompiledModel,
    GraphedValueAndGrad,
    _make_value_and_grad,
    compile_logp,
    constrain_flat,
)
from exmc_tpu_torch.config import default_dtype, prepare_device

# soft clamp on the coupling log-scales (tanh-bounded, smooth)
_LOGS_MAX = 4.0


def _masks(d, num_layers):
    """Alternating even/odd binary masks, (num_layers, d). For d == 1
    the transforming layers' conditioner sees zeros, a bias-only affine."""
    idx = np.arange(d)
    return np.stack([(idx % 2 == k % 2).astype(np.float64) for k in range(num_layers)])


class CouplingFlow(nn.Module):
    """x = f(z): the base affine mu + exp(log_s) z, then the coupling
    layers; each layer keeps its masked half and maps the other half by
    x exp(logs) + shift, (shift, logs) from a tanh MLP of the masked
    half. Works on (N, d) batches."""

    def __init__(self, d, num_layers=4, hidden=32, generator=None, device=None,
                 dtype=None):
        super().__init__()
        dtype = dtype or default_dtype()
        kw = dict(dtype=dtype, device=device)
        self.mu = nn.Parameter(torch.zeros(d, **kw))
        self.log_s = nn.Parameter(torch.full((d,), -1.0, **kw))
        self.w1 = nn.ParameterList(
            [nn.Parameter(0.1 * torch.randn(d, hidden, generator=generator, **kw))
             for _ in range(num_layers)])
        self.b1 = nn.ParameterList(
            [nn.Parameter(torch.zeros(hidden, **kw)) for _ in range(num_layers)])
        self.w2 = nn.ParameterList(
            [nn.Parameter(torch.zeros(hidden, 2 * d, **kw)) for _ in range(num_layers)])
        self.b2 = nn.ParameterList(
            [nn.Parameter(torch.zeros(2 * d, **kw)) for _ in range(num_layers)])
        self.register_buffer("masks", torch.as_tensor(_masks(d, num_layers), **kw))

    @property
    def num_layers(self):
        return len(self.w1)

    def _couple(self, k, x):
        mask = self.masks[k]
        h = torch.tanh((x * mask) @ self.w1[k] + self.b1[k])
        out = h @ self.w2[k] + self.b2[k]
        d = x.shape[-1]
        logs = _LOGS_MAX * torch.tanh(out[..., d:] / _LOGS_MAX)
        return out[..., :d], logs, mask

    def forward(self, z):
        """z (N, d) -> (x (N, d), log|det J_f(z)| (N,))."""
        x = self.mu + torch.exp(self.log_s) * z
        ld = torch.sum(self.log_s)
        for k in range(self.num_layers):
            shift, logs, mask = self._couple(k, x)
            x = mask * x + (1.0 - mask) * (x * torch.exp(logs) + shift)
            ld = ld + torch.sum((1.0 - mask) * logs, dim=-1)
        return x, ld.expand(z.shape[:-1]) if ld.ndim == 0 else ld

    def inverse(self, x):
        """x (N, d) -> (z, log|det J_{f^-1}(x)| (N,)): each coupling layer
        inverts in closed form, since its conditioner reads the half the
        layer leaves unchanged."""
        ld = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for k in reversed(range(self.num_layers)):
            shift, logs, mask = self._couple(k, x)
            x = mask * x + (1.0 - mask) * (x - shift) * torch.exp(-logs)
            ld = ld - torch.sum((1.0 - mask) * logs, dim=-1)
        z = (x - self.mu) * torch.exp(-self.log_s)
        return z, ld - torch.sum(self.log_s)


def init_flow(d, num_layers=4, hidden=32, seed=0, device=None, dtype=None):
    """A ``CouplingFlow`` on ``device`` (default ``"cuda"``), its
    first-layer weights 0.1 N(0, 1) from a generator seeded ``seed``."""
    dev = prepare_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return CouplingFlow(d, num_layers, hidden, generator=gen, device=dev, dtype=dtype)


def flow_forward(flow, z):
    """z (N, d) -> (x, logdet) through ``flow``."""
    return flow(z)


def flow_inverse(flow, x):
    """x (N, d) -> (z, logdet of the inverse) through ``flow``."""
    return flow.inverse(x)


@dataclass
class FlowFit:
    """A trained flow. ``sample`` draws a constrained trace from q,
    ``log_q`` evaluates q's density at flat unconstrained points, and
    ``psis_diagnostic`` gives the Pareto k-hat of weighting q's draws to
    the posterior (k < 0.7: q is close enough for PSIS-corrected
    estimates; else ``sample_neutra``, which is exact regardless)."""

    model: CompiledModel
    flow: Any
    elbo_history: np.ndarray
    data: Any = None

    def sample(self, num_draws=1000, seed=0, return_unconstrained=False, z=None):
        dev = self.model.device
        if z is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            z = torch.randn(num_draws, self.model.size, generator=gen,
                            dtype=default_dtype(), device=dev)
        with torch.no_grad():
            x, _ = self.flow(torch.as_tensor(z, dtype=default_dtype(), device=dev))
            if return_unconstrained:
                return x.cpu().numpy()
            named = constrain_flat(self.model.ir, self.model.pm, x, self.data)
        return {k: v.cpu().numpy()[None] for k, v in named.items()}

    def log_q(self, flat):
        """log q at (N, d) flat points, (N,)."""
        with torch.no_grad():
            z, ld = self.flow.inverse(torch.as_tensor(flat, dtype=default_dtype(),
                                                      device=self.model.device))
        return -0.5 * torch.sum(z * z, dim=-1) - 0.5 * z.shape[-1] * math.log(2 * math.pi) + ld

    def psis_diagnostic(self, num_draws=1000, seed=1):
        from exmc_tpu_torch.model_comparison import _psis_smooth

        x = torch.as_tensor(self.sample(num_draws, seed=seed, return_unconstrained=True),
                            device=self.model.device)
        with torch.no_grad():
            lp = self.model.logp(x, self.model.device_data(self.data))
        log_w = (lp - self.log_q(x)).cpu().numpy()
        _, k, _ = _psis_smooth(log_w[np.isfinite(log_w)])
        return float(k)


def _neg_elbo(model, flow_fn, ddata, z, h_base):
    """The masked negative ELBO of the draws ``z`` (N, d); ``flow_fn(z)
    -> (x, logdet)`` with the parameters in its autograd graph."""
    x, ld = flow_fn(z)
    with torch.no_grad():
        lp_probe = model.logp(x.detach(), ddata)
    ok = torch.isfinite(lp_probe) & torch.isfinite(x).all(-1) & torch.isfinite(ld)
    x_safe = torch.where(ok.unsqueeze(-1), x, torch.zeros_like(x))
    lp = model.logp(x_safe, ddata)
    val = torch.where(ok, lp + ld + h_base, torch.zeros_like(lp))
    n = torch.clamp_min(torch.sum(ok), 1)
    return -torch.sum(val) / n


def _train_step(model, flow, ddata, z, opt_update, opt_state, h_base):
    """One Adam step of the flow's parameters on the draws ``z``, kept
    only if the loss and the new parameters are finite (the optimizer
    state with them). Updates ``flow`` in place; returns (ELBO, the new
    optimizer state)."""
    params = tuple(flow.parameters())
    with torch.enable_grad():
        loss = _neg_elbo(model, flow, ddata, z, h_base)
        grads = torch.autograd.grad(loss, params)
    ups, opt_new = opt_update(_clip_by_global_norm(grads), opt_state)
    with torch.no_grad():
        new = tuple(p + u for p, u in zip(params, ups))
        ok = torch.isfinite(loss)
        for t in new:
            ok = ok & torch.isfinite(t).all()
        for p, t in zip(params, new):
            p.copy_(torch.where(ok, t, p))
    return -loss.detach(), _select(ok, opt_new, opt_state)


class _GraphedSteps:
    """``_train_step`` replayed from one CUDA graph: the draws ``z`` ride
    a static buffer, the flow's parameters and the optimizer state are
    updated in place by the graph, and the step's ELBO is left in
    ``elbo``. The same kernels run on the same inputs, so the steps equal
    the eager ones; the graph is captured after two warm-up steps on
    copies of the flow and the state."""

    def __init__(self, model, flow, ddata, opt_update, state, h_base, z):
        warm_flow = copy.deepcopy(flow)
        warm_state = _clone(state)
        self.z = z.clone()
        side = torch.cuda.Stream(device=z.device)
        side.wait_stream(torch.cuda.current_stream(z.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                _, warm_state = _train_step(model, warm_flow, ddata, self.z, opt_update,
                                            warm_state, h_base)
        torch.cuda.current_stream(z.device).wait_stream(side)
        self.state = _clone(state)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.elbo, new_state = _train_step(model, flow, ddata, self.z, opt_update,
                                               self.state, h_base)
            _copy_into(self.state, new_state)

    def __call__(self, z):
        self.z.copy_(z)
        self.graph.replay()
        return self.elbo.clone()


def _clone(state):
    if isinstance(state, tuple):
        return tuple(_clone(s) for s in state)
    return state.clone()


def _copy_into(dst, src):
    if isinstance(dst, tuple):
        for a, b in zip(dst, src):
            _copy_into(a, b)
    else:
        dst.copy_(src)


def flow_fit(ir, *, num_layers=4, hidden=32, num_iters=1500, num_elbo_draws=16,
             lr=5e-3, seed=0, data=None, ncp=True, device=None, init=None,
             noise=None):
    """Train the coupling flow by reparameterized ELBO ascent on
    ``device`` (default ``"cuda"``; a compiled model keeps its own).
    Returns a ``FlowFit`` whose ``elbo_history`` (num_iters,) records
    E[logp] + H(q) per step.

    ``init``: a ``CouplingFlow`` to start from (copied); ``noise``: the
    training normals, (num_iters, num_elbo_draws, d). On the card the
    training step replays one CUDA graph (the eager step's values),
    unless the model runs eagerly there."""
    model = ir if isinstance(ir, CompiledModel) else compile_logp(ir, ncp=ncp, device=device)
    if data is None:
        data = model.data if isinstance(ir, CompiledModel) else ir.data
    d = model.size
    if d == 0:
        raise ValueError("model has no free parameters")
    dt, dev = default_dtype(), model.device
    ddata = model.device_data(data)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if init is None:
        flow = CouplingFlow(d, num_layers, hidden, generator=gen, device=dev)
    else:
        flow = copy.deepcopy(init).to(dev)
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=dt, device=dev)
    opt_init, opt_update = _adam(lr)
    state = opt_init(tuple(flow.parameters()))
    # + H(base): the recorded ELBO lower-bounds the log evidence
    h_base = 0.5 * d * (1.0 + math.log(2.0 * math.pi))
    elbos, step = [], None
    for i in range(num_iters):
        z = (noise[i] if noise is not None
             else torch.randn(num_elbo_draws, d, generator=gen, dtype=dt, device=dev))
        if dev.type == "cuda" and _capturable(model):
            if step is None:
                step = _GraphedSteps(model, flow, ddata, opt_update, state, h_base, z)
            elbos.append(step(z))
        else:
            elbo, state = _train_step(model, flow, ddata, z, opt_update, state, h_base)
            elbos.append(elbo)
    hist = torch.stack(elbos).cpu().numpy() if elbos else np.zeros(0, np.float32)
    return FlowFit(model=model, flow=flow, elbo_history=hist, data=data)


def neutra_model(fit: FlowFit):
    """The z-space model of ``fit``: logp(f(z)) + log|det J_f(z)| with
    the flow's parameters frozen, its value-and-grad in z replayed from a
    CUDA graph on the card; cached on the fit."""
    cached = getattr(fit, "_neutra_model", None)
    if cached is not None:
        return cached
    model = fit.model
    frozen = copy.deepcopy(fit.flow).requires_grad_(False)

    def logp_z(z, data=None):
        x, ld = frozen(z)
        return model.logp(x, data) + ld

    vag = _make_value_and_grad(logp_z)
    # ncp_info={}: the z-space model has no hierarchy for interweave
    cached = CompiledModel(ir=model.ir, pm=model.pm, ncp_info={}, logp=logp_z,
                           value_and_grad=(GraphedValueAndGrad(vag)
                                           if _capturable(model) else vag),
                           device=model.device, data=fit.data)
    cached.flow = frozen
    fit._neutra_model = cached
    return cached


def _capturable(model):
    """Whether the model's own value-and-grad is replayed from a graph
    (a sampled matrix factorization keeps a model eager)."""
    return isinstance(model.value_and_grad, GraphedValueAndGrad)


def sample_neutra(ir, *, flow=None, flow_kwargs=None, data=None, ncp=True,
                  return_unconstrained=False, device=None, **sample_opts):
    """NeuTra-HMC: NUTS on the flow's pulled-back density in z space,
    the draws pushed through the flow and constrained. ``flow``: a
    ``FlowFit`` (its z-space model is cached on it); omitted, one is
    trained with ``flow_kwargs``. Other keywords go to ``sample``.
    Returns (trace, stats) like ``sample``."""
    from exmc_tpu_torch.nuts.sampler import sample

    if flow is None:
        flow = flow_fit(ir, data=data, ncp=ncp, device=device, **(flow_kwargs or {}))
    elif flow_kwargs:
        raise ValueError("pass flow= or flow_kwargs=, not both")
    if data is None:
        data = flow.data
    zmodel = neutra_model(flow)
    model, d = flow.model, flow.model.size
    zdraws, stats = sample(zmodel, data=data, return_unconstrained=True, **sample_opts)
    c, s = zdraws.shape[:2]
    with torch.no_grad():
        x, _ = zmodel.flow(torch.as_tensor(zdraws.reshape(-1, d), device=model.device))
        if return_unconstrained:
            return x.cpu().numpy().reshape(zdraws.shape), stats
        named = constrain_flat(model.ir, model.pm, x, data)
    return {k: v.cpu().numpy().reshape((c, s) + tuple(v.shape[1:]))
            for k, v in named.items()}, stats
