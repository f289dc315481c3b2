"""Compile a model IR into one batched, differentiable log-density
(``exmc_tpu/compiler.py:193-475,499-508``).

Where the JAX package compiles ``logp(flat) -> scalar`` and vmaps it
over chains, the port evaluates a (C, d) batch of flat points at once:
``logp(flat) -> (C,)``. Every value inside carries a leading chain axis
(1 for constants), and every sum the JAX code takes over all axes of
one point is taken here over the event axes only (``math.event_sum``),
so chains never mix. ``value_and_grad`` is one ``torch.autograd.grad``
of the chain-summed logp; since chain i's logp depends on row i alone,
row i of that gradient is exactly chain i's gradient. On the card the
value-and-grad is replayed from a CUDA graph per batch shape
(``GraphedValueAndGrad``).

Non-centered latents are rebuilt as ``mu + sigma * z``, and a
GaussianRandomWalk latent as ``sigma * cumsum(z)``, with ``z = V w``
when the rewrite made it spectral (``_grw_spectral_basis``).

Not ported yet, and refused when the model is compiled: censored
observations, measurable-lifted observations (``meas_obs``), keyed data
references, the pointwise log-likelihood and ``partial_logp``
(ROADMAP §1 items 3 and 10).
"""

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from exmc_tpu_torch import math as xm
from exmc_tpu_torch import rewrite
from exmc_tpu_torch import transforms as tf
from exmc_tpu_torch.config import default_dtype, prepare_device
from exmc_tpu_torch.dists.base import get as get_dist
from exmc_tpu_torch.ir import IR
from exmc_tpu_torch.point_map import PointMap

OBS_DATA_KEY = "__obs_data"


def _event_mean(x):
    return x if x.ndim <= 1 else x.flatten(1).mean(1)


def _event_logsumexp(x):
    return x if x.ndim <= 1 else torch.logsumexp(x.flatten(1), dim=1)


def _matmul(a, x):
    """The JAX package's ``matmul(a, x)`` of one point, per chain: both
    operands carry a leading chain axis (1 for a constant), and the
    product is taken over their event axes. A constant (1, m, k) design
    matrix against (C, k) coefficients is one (C, k) x (k, m) product,
    giving (C, m)."""
    ea, ex = a.ndim - 1, x.ndim - 1
    if ex == 1:
        if ea == 2 and a.shape[0] == 1:
            return x @ a[0].T
        if ea == 1:
            return torch.sum(a * x, dim=-1)
        return torch.matmul(a, x.unsqueeze(-1)).squeeze(-1)
    if ea == 1:
        return torch.matmul(a.unsqueeze(-2), x).squeeze(-2)
    return torch.matmul(a, x)


# Deterministic-node ops that act elementwise (or reduce over the event
# axes) on batched values: their arguments are aligned first (``_align``).
# The JAX table's dot/getitem/smul/cumsum/stack/concat wait for the
# models that need them (ROADMAP §1).
DET_OPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "neg": lambda a: -a,
    "exp": torch.exp,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "abs": torch.abs,
    "sum": xm.event_sum,
    "mean": _event_mean,
    "sigmoid": lambda x: torch.reciprocal(1.0 + torch.exp(-x)),
    "softplus": xm.softplus,
    "identity": lambda x: x,
    "affine": lambda a, b, x: a * x + b,
}

# Det ops over the event axes as a whole, given their arguments unaligned.
UNALIGNED_DET_OPS = {"matmul": _matmul}


def _grw_spectral_basis(t):
    """Orthonormal eigenbasis of the cumsum gram C^T C (C the (t, t)
    lower-triangular ones matrix), in float64 numpy:

        V[i, k] = 2/sqrt(2t+1) * sin((2k+1) pi (t-i) / (2t+1))

    A GRW latent sampled as w with z = V w keeps its N(0, I) prior
    (|w| = |z|) while the likelihood curvature of iid observations of
    s = sigma * cumsum(z) becomes diagonal in w
    (``exmc_tpu/compiler.py:166-190``)."""
    i = np.arange(t)[:, None]
    k = np.arange(t)[None, :]
    return 2.0 / np.sqrt(2 * t + 1) * np.sin(
        (2 * k + 1) * np.pi * (t - i) / (2 * t + 1))


def _ncp_invert(info, x, mu, sigma):
    """Inverse of the NCP reconstruction, per chain: z = (x - mu) / sigma;
    for the GRW kind the first differences over sigma, rotated by
    w = V^T z when spectral. ``x`` is (C, *event) and ``mu``/``sigma``
    are aligned against it."""
    if info.get("kind") == "grw":
        inc = torch.cat([x[..., :1], torch.diff(x, dim=-1)], dim=-1)
        z = inc / sigma
        if info.get("spectral"):
            v = torch.as_tensor(_grw_spectral_basis(z.shape[-1]),
                                dtype=z.dtype, device=z.device)
            z = z @ v
        return z
    return (x - mu) / sigma


def _align(vals):
    """Insert unit axes right after the chain axis so every batched
    tensor has the same number of event axes; event axes then broadcast
    right-aligned, as they do for one point in JAX. 0-d tensors are
    scalars and broadcast anywhere."""
    nd = max((v.ndim for v in vals if v.ndim > 0), default=0)
    return [
        v.reshape(v.shape[:1] + (1,) * (nd - v.ndim) + v.shape[1:])
        if 0 < v.ndim < nd else v
        for v in vals
    ]


def _align_dict(x, params):
    keys = list(params)
    vals = _align([x] + [params[k] for k in keys])
    return vals[0], dict(zip(keys, vals[1:]))


def _const(value, device):
    """A constant as a device tensor: 0-d for a scalar, (1, *shape) for
    an array (a chain axis of 1)."""
    arr = np.asarray(value)
    dtype = torch.bool if arr.dtype == np.bool_ else default_dtype()
    t = torch.as_tensor(arr.astype(np.bool_ if dtype == torch.bool else np.float32),
                        device=device)
    return t if t.ndim == 0 else t.unsqueeze(0)


@dataclass
class CompiledModel:
    """Compiled model: the rewritten IR, its flat layout and the batched
    log-density with its gradient."""

    ir: IR                      # rewritten IR
    pm: PointMap
    ncp_info: dict
    logp: Callable              # (C, d) -> (C,)
    value_and_grad: Callable    # (C, d) -> ((C,), (C, d))
    device: torch.device
    data: Any = None

    @property
    def size(self) -> int:
        return self.pm.size

    def constrain(self, flat):
        """(N, d) flat unconstrained -> {name: (N, *shape) constrained},
        NCP reconstruction included."""
        return constrain_flat(self.ir, self.pm, flat, self.data)


class _Graph:
    """The rewritten IR with every constant turned into a device tensor
    once, at compile time, so no evaluation copies from the host."""

    def __init__(self, ir: IR, pm: PointMap, device, data=None):
        self.ir = ir
        self.free_ids = {e.id for e in pm.entries}
        self.data = None if data is None else _const(data, device)
        prep = self._prep_factory(device)
        self.params, self.args, self.values, self.meta = {}, {}, {}, {}
        for nid, node in ir.nodes.items():
            tag = node.op[0]
            if tag == "rv":
                self.params[nid] = {k: prep(v) for k, v in node.op[2].items()}
            elif tag == "det":
                fn = node.op[1]
                if isinstance(fn, str) and fn not in DET_OPS and (
                        fn not in UNALIGNED_DET_OPS):
                    raise NotImplementedError(
                        f"det op {fn!r} of node {nid!r} is not ported yet "
                        "(ROADMAP §1 item 15)")
                self.args[nid] = [prep(a) for a in node.op[2]]
            elif tag == "obs":
                _, _, value, meta = node.op
                if meta.get("censored") is not None:
                    raise NotImplementedError(
                        f"censored observation {nid!r} is not ported yet "
                        "(ROADMAP §1 item 3)")
                if isinstance(value, (dict, tuple)) or (
                        isinstance(value, str) and value != OBS_DATA_KEY):
                    raise NotImplementedError(
                        f"observation {nid!r}: only array values and "
                        f"{OBS_DATA_KEY!r} are ported (ROADMAP §1 item 3)")
                self.values[nid] = prep(value)
                weight = meta.get("weight", 1.0)
                mask = meta.get("mask")
                self.meta[nid] = {
                    "weight": (None if isinstance(weight, float) and weight == 1.0
                               else prep(weight)),
                    "mask": None if mask is None else _const(
                        np.asarray(mask, dtype=bool), device),
                    "reduce": meta.get("reduce"),
                }
            elif tag == "meas_obs":
                raise NotImplementedError(
                    f"measurable observation {nid!r} is not ported yet "
                    "(ROADMAP §1 item 3)")
        # mu/sigma become device tensors; "kind"/"spectral" stay flags
        self.ncp = {
            nid: {k: prep(v) if k in ("mu", "sigma") else v
                  for k, v in info.items()}
            for nid, info in ir.ncp_info.items()
        }
        # spectral GRW bases, built in float64 and cast once
        self.bases = {
            nid: torch.as_tensor(_grw_spectral_basis(ir.nodes[nid].shape[-1]),
                                 dtype=default_dtype(), device=device)
            for nid, info in ir.ncp_info.items() if info.get("spectral")
        }

    @staticmethod
    def _prep_factory(device):
        def prep(v):
            return v if isinstance(v, str) else _const(v, device)
        return prep

    def resolver(self, zmap):
        """Constrained-value resolver with memoization, applying NCP
        reconstruction ``mu + sigma * z`` recursively."""
        memo = {}
        ir = self.ir

        def val(v):
            return resolve(v) if isinstance(v, str) else v

        def resolve(ref):
            if ref == OBS_DATA_KEY:
                return self.data
            if ref in memo:
                return memo[ref]
            node = ir.get_node(ref)
            tag = node.op[0]
            if tag == "det":
                fn = node.op[1]
                args = [val(a) for a in self.args[ref]]
                if isinstance(fn, str) and fn in UNALIGNED_DET_OPS:
                    out = UNALIGNED_DET_OPS[fn](*args)
                else:
                    fn = DET_OPS[fn] if isinstance(fn, str) else fn
                    out = fn(*_align(args))
            elif tag == "rv":
                if ref not in self.free_ids:
                    raise ValueError(
                        f"node {ref!r} referenced but is observed — reference "
                        "the observation's value directly")
                transform = node.op[3] if len(node.op) == 4 else None
                out = tf.get(transform).forward(zmap[ref])
                info = self.ncp.get(ref)
                if info is not None and info.get("kind") == "grw":
                    if ref in self.bases:
                        out = out @ self.bases[ref].T  # z = V w
                    sig_v, out = _align([val(info["sigma"]), out])
                    out = sig_v * torch.cumsum(out, dim=-1)
                elif info is not None:
                    mu_v, sig_v, out = _align(
                        [val(info["mu"]), val(info["sigma"]), out])
                    out = mu_v + sig_v * out
            else:
                raise ValueError(f"cannot resolve node {ref!r} of kind {tag!r}")
            memo[ref] = out
            return out

        return resolve, val

    def rv_prior_term(self, node, zmap, val):
        """Free-RV log-prior + transform Jacobian, per chain."""
        dist = get_dist(node.op[1])
        transform = node.op[3] if len(node.op) == 4 else None
        t = tf.get(transform)
        z = zmap[node.id]
        x = t.forward(z)
        params = {k: val(v) for k, v in self.params[node.id].items()}
        x, params = _align_dict(x, params)
        return xm.event_sum(dist.logpdf(x, params)) + t.log_abs_det_jacobian(z)

    def obs_term(self, node, val):
        """Observation log-likelihood with weight -> mask -> reduce."""
        target = self.ir.get_node(node.op[1])
        dist = get_dist(target.op[1])
        params = {k: val(v) for k, v in self.params[target.id].items()}
        value, params = _align_dict(val(self.values[node.id]), params)
        lp = dist.logpdf(value, params)
        meta = self.meta[node.id]
        if meta["weight"] is not None:
            lp, w = _align([lp, meta["weight"]])
            lp = lp * w
        if meta["mask"] is not None:
            lp, m = _align([lp, meta["mask"]])
            lp = torch.where(m, lp, torch.zeros_like(lp))
        if meta["reduce"] == "mean":
            return _event_mean(lp)
        if meta["reduce"] == "logsumexp":
            return _event_logsumexp(lp)
        return lp


def _make_logp(graph: _Graph, pm: PointMap):
    ir = graph.ir
    node_ids = sorted(ir.nodes)  # deterministic term order

    def logp(flat):
        zmap = pm.unpack(flat)
        _, val = graph.resolver(zmap)
        total = flat.new_zeros(flat.shape[:1])
        for nid in node_ids:
            node = ir.nodes[nid]
            tag = node.op[0]
            if tag == "rv" and nid in graph.free_ids:
                total = total + graph.rv_prior_term(node, zmap, val)
            elif tag == "obs" and node.op[-1].get("likelihood", True) is not False:
                total = total + xm.event_sum(graph.obs_term(node, val))
        return total

    return logp


def _make_value_and_grad(logp):
    def value_and_grad(flat):
        with torch.enable_grad():
            x = flat.detach().requires_grad_(True)
            lp = logp(x)
            (g,) = torch.autograd.grad(lp.sum(), x)
        return lp.detach(), g

    return value_and_grad


class GraphedValueAndGrad:
    """``value_and_grad`` replayed from a CUDA graph, one per input shape.

    The model's forward and backward are hundreds of small kernels per
    call, and launching them one by one from the host is what bounds the
    sampler on the card (PERF.md). A graph captures them once and a
    replay launches them together. The same kernels run on the same
    inputs, so the results equal the eager call's; each call returns
    fresh tensors (the graph's outputs are overwritten by the next
    replay). CPU tensors take the eager path."""

    def __init__(self, vag):
        self.eager = vag
        self.graphs = {}

    def __call__(self, flat):
        if flat.device.type != "cuda":
            return self.eager(flat)
        key = (tuple(flat.shape), flat.dtype, flat.device)
        if key not in self.graphs:
            self.graphs[key] = self._capture(flat)
        x, lp, g, graph = self.graphs[key]
        x.copy_(flat)
        graph.replay()
        return lp.clone(), g.clone()

    def _capture(self, flat):
        x = flat.detach().clone()
        stream = torch.cuda.current_stream(flat.device)
        side = torch.cuda.Stream(device=flat.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            for _ in range(2):  # warm autograd and the allocator first
                self.eager(x)
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            lp, g = self.eager(x)
        return x, lp, g, graph


def compile_logp(ir: IR, *, ncp: bool = True, rewritten: bool = False,
                 device=None) -> CompiledModel:
    """Rewrite + compile an IR into a CompiledModel on ``device``
    (default ``"cuda"``)."""
    dev = prepare_device(device)
    rw = ir if rewritten else rewrite.apply(ir, ncp=ncp)
    pm = PointMap.build(rw)
    graph = _Graph(rw, pm, dev, rw.data)
    logp = _make_logp(graph, pm)
    return CompiledModel(ir=rw, pm=pm, ncp_info=rw.ncp_info, logp=logp,
                         value_and_grad=GraphedValueAndGrad(
                             _make_value_and_grad(logp)),
                         device=dev, data=rw.data)


def constrain_flat(ir: IR, pm: PointMap, flat, data=None) -> dict:
    """(N, d) flat -> {name: (N, *shape)} constrained values with NCP
    reconstruction. ``data`` overrides ``ir.data``."""
    graph = _Graph(ir, pm, flat.device, ir.data if data is None else data)
    resolve, _ = graph.resolver(pm.unpack(flat))
    n = flat.shape[0]
    out = {}
    for e in pm.entries:
        v = resolve(e.id)
        out[e.id] = v.expand((n,) + tuple(v.shape[1:])) if v.ndim else v.expand(n)
    return out
