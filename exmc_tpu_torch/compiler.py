"""Compile a model IR into one batched, differentiable log-density
(``exmc_tpu/compiler.py``).

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

Before a distribution sees its value and parameters they are aligned on
their batch axes (``_align_dist``): each tensor keeps its own trailing
event axes (a Categorical's probabilities, an MvNormal's factor), and
the axes between the chain axis and those broadcast right-aligned, as
they do for one point in JAX. Det ops that are not elementwise
(``matmul``, ``dot``, ``getitem``, ``smul``, ``cumsum``, ``stack``,
``concat``) act on the event axes and take their operands unaligned.
A user's det callable sees one point, as in JAX: it is applied with
``torch.func.vmap`` over the chain axis (``_per_point``); only the Stan
frontend's factor callables take the aligned batch (``ir._batched``).

Non-centered latents are rebuilt as ``mu + sigma * z``, and a
GaussianRandomWalk latent as ``sigma * cumsum(z)``, with ``z = V w``
when the rewrite made it spectral (``_grw_spectral_basis``).
Observations may be censored (``Censored``), measurable-lifted
(``meas_obs``: the matmul and affine Jacobians), or read from the data
registered with ``Builder.data``, whole (``"__obs_data"``) or keyed
(``("__obs_data", key)``).

That data is also the runtime data channel: ``logp(flat, data)`` and
``value_and_grad(flat, data)`` read ``"__obs_data"`` refs from the
call's ``data`` (None: the model's own), so a compiled model reruns on
new observations without a recompile. A run moves its data to the
device once (``CompiledModel.device_data``); the CUDA graph of
``GraphedValueAndGrad`` then reads it from static input buffers.
"""

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from exmc_tpu_torch import math as xm
from exmc_tpu_torch import rewrite
from exmc_tpu_torch import transforms as tf
from exmc_tpu_torch.config import default_dtype, np_dtype, prepare_device
from exmc_tpu_torch.dists.base import get as get_dist
from exmc_tpu_torch.dists.composite import CENSORED
from exmc_tpu_torch.ir import IR, _is_batched
from exmc_tpu_torch.point_map import PointMap

OBS_DATA_KEY = "__obs_data"


def _resolve_value(value, data):
    """An observation's value in raw form: an array, a {"lower",
    "upper"} dict, ``"__obs_data"`` (the data, or its ``"__base"``) or
    a keyed ``("__obs_data", key)`` ref (``data[key]``)."""
    if isinstance(value, str):
        if value == OBS_DATA_KEY:
            return _base_data(data)
        raise ValueError(f"bad obs value ref: {value!r}")
    if isinstance(value, tuple) and len(value) == 2 and value[0] == OBS_DATA_KEY:
        return data[value[1]]
    return value


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


def _smul(a, b):
    """Stan's ``*``: a matrix product when the left operand is a matrix
    (two event axes), else elementwise."""
    if a.ndim == 3:
        return _matmul(a, b)
    return torch.mul(*_align([a, b]))


def _getitem(v, idx):
    """``v[idx]`` of one point, per chain: ``idx`` (a constant integer
    tensor) indexes the first event axis."""
    return v[:, idx]


def _cumsum(x):
    if x.ndim < 2:
        raise ValueError("det op 'cumsum' needs a vector-valued argument")
    return torch.cumsum(x, dim=-1)


def _stack(*xs):
    """``stack(xs)`` of one point: a new first event axis."""
    xs = [x if x.ndim else x.reshape(1) for x in xs]
    return torch.stack(torch.broadcast_tensors(*_align(xs)), dim=1)


def _concat(*xs):
    """``concatenate(xs)`` of one point, along the first event axis."""
    xs = _align(list(xs))
    c = max(x.shape[0] for x in xs)
    return torch.cat([x.expand((c,) + x.shape[1:]) for x in xs], dim=1)


# Deterministic-node ops that act elementwise (or reduce over the event
# axes) on batched values: their arguments are aligned first (``_align``).
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
UNALIGNED_DET_OPS = {
    "matmul": _matmul,
    "dot": _matmul,
    "getitem": _getitem,
    "smul": _smul,
    "cumsum": _cumsum,
    "stack": _stack,
    "concat": _concat,
}


def _per_point(nid, fn, args):
    """A user callable of det node ``nid`` applied one point at a time,
    as the JAX package applies it: ``torch.func.vmap`` over the chain
    axis. An argument with a chain axis of 1 (a constant, or data) goes
    in whole with that axis dropped, unless every argument has it (a
    batch of one chain); a 0-d scalar goes in whole. An argument with
    another number of rows than the batch (data of other chains), or a
    callable that cannot run under vmap (a shape that depends on the
    values, a host read), raises an error that names the node."""
    c = max((a.shape[0] for a in args if isinstance(a, torch.Tensor) and a.ndim),
            default=0)
    if c == 0:
        out = fn(*args)
        return out.unsqueeze(0) if isinstance(out, torch.Tensor) and out.ndim else out
    xs, dims = [], []
    for a in args:
        if not isinstance(a, torch.Tensor) or a.ndim == 0:
            xs.append(a)
            dims.append(None)
        elif a.shape[0] == c:
            xs.append(a)
            dims.append(0)
        elif a.shape[0] == 1:
            xs.append(a[0])
            dims.append(None)
        else:
            raise ValueError(
                f"det node {nid!r}: an argument has {a.shape[0]} rows where the "
                f"batch has {c} chains (one row, or one per chain)")
    try:
        return torch.func.vmap(fn, in_dims=tuple(dims))(*xs)
    except Exception as e:  # noqa: BLE001 - re-raised with the node's name
        raise ValueError(
            f"det node {nid!r}: its callable must run on one point at a time "
            f"under torch.func.vmap over the chain axis, and it failed there "
            f"({type(e).__name__}: {e})") from e


def _apply_det(nid, fn, args):
    """Det node ``nid``'s value from its resolved args: a table op, a
    Stan factor callable (``ir._batched``) on the aligned batch, any other
    callable one point at a time."""
    if isinstance(fn, str) and fn in UNALIGNED_DET_OPS:
        return UNALIGNED_DET_OPS[fn](*args)
    if isinstance(fn, str) or _is_batched(fn):
        fn = DET_OPS[fn] if isinstance(fn, str) else fn
        return fn(*_align(args))
    return _per_point(nid, fn, args)


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


def _align_batch(leaves):
    """``leaves``: (tensor, event_dims) pairs. Insert unit axes after the
    chain axis so every tensor has the same number of batch axes (those
    between the chain axis and its own event axes). 0-d tensors are
    scalars and broadcast anywhere."""
    nb = max((t.ndim - 1 - k for t, k in leaves
              if isinstance(t, torch.Tensor) and t.ndim > 0), default=0)
    out = []
    for t, k in leaves:
        if isinstance(t, torch.Tensor) and t.ndim > 0 and t.ndim - 1 - k < nb:
            t = t.reshape(t.shape[:1] + (1,) * (nb - (t.ndim - 1 - k)) + t.shape[1:])
        out.append(t)
    return out


def _align_dist(dist, value, params):
    """(value, params) aligned on their batch axes for ``dist.logpdf``,
    each keeping the event axes the distribution declares for it
    (``value_event_dims``, ``param_event_dims``); a Mixture's component
    parameters use their component's declaration. ``value`` may be a
    dict (interval censoring). A distribution with ``align = False``
    (``Custom(..., align=False)``) gets them as they are, each with its
    chain axis (1 for constants) or 0-d."""
    if not dist.align:
        return value, params
    leaves = []

    def leaf(t, k):
        leaves.append((t, k))
        return len(leaves) - 1

    vk = dist.value_event_dims
    if dist.name == "mixture":
        vk = get_dist(params["components"][0]).value_event_dims
    vspec = ({n: leaf(v, vk) for n, v in value.items()}
             if isinstance(value, dict) else leaf(value, vk))
    pspec = {}
    for k, v in params.items():
        if k in ("components", "__data__"):
            pspec[k] = v
        elif k == "params" and dist.name == "mixture":
            comps = [get_dist(c) for c in params["components"]]
            pspec[k] = [{kk: leaf(vv, c.param_event_dims.get(kk, 0))
                         for kk, vv in p.items()} for c, p in zip(comps, v)]
        elif isinstance(v, dict):
            pspec[k] = {kk: leaf(vv, 0) for kk, vv in v.items()}
        else:
            pspec[k] = leaf(v, dist.param_event_dims.get(k, 0))
    out = _align_batch(leaves)

    def get(spec):
        if isinstance(spec, int):
            return out[spec]
        if isinstance(spec, dict):
            return {k: get(v) for k, v in spec.items()}
        return [get(v) for v in spec]

    value = get(vspec)
    params = {k: (v if k in ("components", "__data__") else get(v))
              for k, v in pspec.items()}
    return value, params


def _map_params(params, fn):
    """``fn`` applied to every value of an rv's params: at compile time
    it turns constants into device tensors, per call it resolves
    references. A Mixture's component list stays; its component params
    recurse."""
    out = {}
    for k, v in params.items():
        if k == "components":
            out[k] = v
        elif k == "params" and isinstance(v, (list, tuple)):
            out[k] = [_map_params(p, fn) for p in v]
        elif isinstance(v, dict):
            out[k] = {kk: fn(vv) for kk, vv in v.items()}
        else:
            out[k] = fn(v)
    return out


def _const(value, device):
    """A constant as a device tensor: 0-d for a scalar, (1, *shape) for
    an array (a chain axis of 1)."""
    arr = np.asarray(value)
    dtype = torch.bool if arr.dtype == np.bool_ else default_dtype()
    t = torch.as_tensor(arr.astype(np.bool_ if dtype == torch.bool else np_dtype()),
                        device=device)
    return t if t.ndim == 0 else t.unsqueeze(0)


@dataclass(frozen=True)
class DeviceData:
    """Observation data on a model's device, in the form the compiled
    log-density reads: a tensor, or a dict of tensors, each with a
    leading axis of 1 (0-d for a scalar). Made once per run by
    ``CompiledModel.device_data``."""

    value: Any

    def leaves(self):
        if isinstance(self.value, dict):
            return [self.value[k] for k in sorted(self.value)]
        return [self.value]

    def with_leaves(self, leaves):
        if isinstance(self.value, dict):
            return DeviceData(dict(zip(sorted(self.value), leaves)))
        return DeviceData(leaves[0])

    def rows(self, index):
        """The data of the chains ``index`` picks: leaves with one row per
        chain indexed, the others (one row for all) kept."""
        return self.with_leaves([v[index] if v.ndim and v.shape[0] > 1 else v
                                 for v in self.leaves()])


def _device_value(data, device):
    """The compiled form of ``data`` (raw arrays, a dict of them, or a
    ``DeviceData``); None stays None."""
    if data is None:
        return None
    if isinstance(data, DeviceData):
        return data.value
    if isinstance(data, dict):
        return {k: _const(v, device) for k, v in data.items()}
    return _const(data, device)


def _base_data(data):
    """The value plain "__obs_data" refs see: with keyed data the
    model's own data rides the reserved "__base" key."""
    if isinstance(data, dict) and "__base" in data:
        return data["__base"]
    return data


@dataclass
class CompiledModel:
    """Compiled model: the rewritten IR, its flat layout and the batched
    log-density with its gradient."""

    ir: IR                      # rewritten IR
    pm: PointMap
    ncp_info: dict
    logp: Callable              # ((C, d), data=None) -> (C,)
    value_and_grad: Callable    # ((C, d), data=None) -> ((C,), (C, d))
    device: torch.device
    data: Any = None            # the model's own data (Builder.data)

    @property
    def size(self) -> int:
        return self.pm.size

    def device_data(self, data=None):
        """``data`` (None: the model's own) as a ``DeviceData`` on the
        model's device, or None when there is none."""
        if isinstance(data, DeviceData):
            return data
        data = self.data if data is None else data
        return None if data is None else DeviceData(_device_value(data, self.device))

    def constrain(self, flat, data=None):
        """(N, d) flat unconstrained -> {name: (N, *shape) constrained},
        NCP reconstruction included."""
        return constrain_flat(self.ir, self.pm, flat,
                              self.data if data is None else data)

    def unconstrain(self, xmap):
        """{name: constrained value of one point} -> (d,) flat, inverting
        the transforms and the NCP reconstruction z = (x - mu) / sigma,
        the GRW and affine kinds included (``exmc_tpu/compiler.py:106``).
        A mu or sigma that names a det node is evaluated over the point's
        values, the NCP nodes' inverted first."""
        return self.unconstrain_batch({k: np.asarray(v)[None] for k, v in xmap.items()})[0]

    def unconstrain_batch(self, xmap):
        """``unconstrain`` of N points at once: {name: (N, *shape)} ->
        (N, d)."""
        dev = self.device
        xmap = {k: torch.as_tensor(np.array(v, np_dtype()), device=dev)
                for k, v in xmap.items()}
        zmap = dict(xmap)
        val = None

        def ref(v):
            if not isinstance(v, str):
                return _const(v, dev)
            return xmap[v] if v in xmap else val(v)

        def invert(nid, info):
            mu, sigma, x = _align([ref(info["mu"]), ref(info["sigma"]), xmap[nid]])
            zmap[nid] = _ncp_invert(info, x, mu, sigma)

        pending = {}
        for nid, info in self.ncp_info.items():
            if all(not isinstance(info[k], str) or info[k] in xmap for k in ("mu", "sigma")):
                invert(nid, info)
            else:
                pending[nid] = info
        if pending:
            graph = _Graph(self.ir, self.pm, dev, self.data)
            _, val = graph.resolver(self.pm.unpack(self.pm.to_unconstrained(zmap)), graph.data)
            for nid, info in pending.items():
                invert(nid, info)
        return self.pm.to_unconstrained(zmap)


class _Graph:
    """The rewritten IR with every constant turned into a device tensor
    once, at compile time, so no evaluation copies from the host."""

    def __init__(self, ir: IR, pm: PointMap, device, data=None):
        self.ir = ir
        self.device = device
        self.free_ids = {e.id for e in pm.entries}
        prep = self._prep_factory(device)
        self.data = _device_value(data, device)
        self.params, self.args, self.values, self.meta = {}, {}, {}, {}
        self.meas = {}
        # False when an op without a CUDA-graph form runs per call (a
        # factorization of a sampled matrix): then the card runs eager
        self.capturable = True
        for nid, node in ir.nodes.items():
            tag = node.op[0]
            if tag == "rv":
                dist = get_dist(node.op[1])
                dist.validate_ir_params(node.op[2])
                if dist.name == "mv_normal" and isinstance(node.op[2].get("cov"), str):
                    self.capturable = False
                self.params[nid] = dist.prepare_params(_map_params(node.op[2], prep))
            elif tag == "det":
                fn = node.op[1]
                if isinstance(fn, str) and fn not in DET_OPS and (
                        fn not in UNALIGNED_DET_OPS):
                    raise ValueError(f"unknown det op {fn!r} of node {nid!r}")
                args = [prep(a) for a in node.op[2]]
                if fn == "getitem":
                    args[1] = torch.as_tensor(np.asarray(node.op[2][1]),
                                              dtype=torch.long, device=device)
                self.args[nid] = args
            elif tag in ("obs", "meas_obs"):
                value, meta = node.op[2], node.op[-1]
                self.values[nid] = self._prep_value(value, prep)
                weight = meta.get("weight", 1.0)
                mask = meta.get("mask")
                self.meta[nid] = {
                    "weight": (None if isinstance(weight, float) and weight == 1.0
                               else prep(weight)),
                    "mask": None if mask is None else _const(
                        np.asarray(mask, dtype=bool), device),
                    "reduce": meta.get("reduce"),
                    "censored": meta.get("censored"),
                }
                if tag == "meas_obs":
                    self.meas[nid] = self._prep_meas(nid, node.op[3], prep)
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

    def check_callables(self, pm):
        """Resolve every det node holding a per-point callable once, on a
        batch of two zero points, so that a callable vmap cannot run
        fails at compile time with the node's name."""
        ids = [nid for nid, n in self.ir.nodes.items()
               if n.op[0] == "det" and not isinstance(n.op[1], str)
               and not _is_batched(n.op[1])]
        if not ids:
            return
        flat = torch.zeros(2, pm.size, dtype=default_dtype(), device=self.device)
        resolve, _ = self.resolver(pm.unpack(flat), self.data)
        for nid in sorted(ids):
            resolve(nid)

    def _prep_meas(self, nid, op_info, prep):
        """A measurable lift's operands; a matmul lift of a constant
        matrix against a constant value is solved here, once."""
        kind = op_info[0]
        if kind == "affine":
            return ("affine",) + tuple(prep(a) for a in op_info[1:])
        if kind != "matmul":
            raise ValueError(f"unknown measurable op: {kind!r}")
        a = prep(op_info[1])
        if isinstance(a, str) or self.values[nid][0] != "const":
            self.capturable = False
            return ("matmul", a)
        x, jac = _solve_lift(a, self.values[nid][1])
        return ("solved", x, jac)

    @staticmethod
    def _prep_factory(device):
        def prep(v):
            return v if isinstance(v, str) else _const(v, device)
        return prep

    @staticmethod
    def _prep_value(value, prep):
        """An observation's value: the data (whole or keyed), an interval
        dict, or a constant."""
        if isinstance(value, str):
            if value != OBS_DATA_KEY:
                raise ValueError(f"bad obs value ref: {value!r}")
            return ("data", None)
        if isinstance(value, tuple) and len(value) == 2 and value[0] == OBS_DATA_KEY:
            return ("keyed", value[1])
        if isinstance(value, dict):
            return ("dict", {k: prep(v) for k, v in value.items()})
        return ("const", prep(value))

    def value(self, nid, data):
        """An observation's value; ``data`` is the call's compiled data."""
        kind, v = self.values[nid]
        if kind == "data":
            return _base_data(data)
        if kind == "keyed":
            return data[v]
        return v

    def resolver(self, zmap, data):
        """Constrained-value resolver with memoization, applying NCP
        reconstruction ``mu + sigma * z`` recursively; "__obs_data"
        resolves to ``data``, the call's compiled data."""
        memo = {}
        ir = self.ir

        def val(v):
            return resolve(v) if isinstance(v, str) else v

        def resolve(ref):
            if ref == OBS_DATA_KEY:
                return _base_data(data)
            if ref in memo:
                return memo[ref]
            node = ir.get_node(ref)
            tag = node.op[0]
            if tag == "det":
                fn = node.op[1]
                out = _apply_det(ref, fn, [val(a) for a in self.args[ref]])
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
        params = _map_params(self.params[node.id], val)
        if dist.name == "custom":
            params["__data__"] = val(OBS_DATA_KEY)
        x, params = _align_dist(dist, x, params)
        return xm.event_sum(dist.logpdf(x, params)) + t.log_abs_det_jacobian(z)

    def apply_obs_meta(self, lp, meta, reduce=True):
        """weight -> mask -> reduce, in that order."""
        if meta["weight"] is not None:
            lp, w = _align([lp, meta["weight"]])
            lp = lp * w
        if meta["mask"] is not None:
            lp, m = _align([lp, meta["mask"]])
            lp = torch.where(m, lp, torch.zeros_like(lp))
        if not reduce:
            return lp
        if meta["reduce"] == "sum":
            return xm.event_sum(lp)
        if meta["reduce"] == "mean":
            return _event_mean(lp)
        if meta["reduce"] == "logsumexp":
            return _event_logsumexp(lp)
        return lp

    def _target(self, node, val):
        target = self.ir.get_node(node.op[1])
        dist = get_dist(target.op[1])
        return dist, _map_params(self.params[target.id], val)

    def obs_term(self, node, val, data, reduce=True):
        """Observation log-likelihood (censored or not) with its meta."""
        dist, params = self._target(node, val)
        if dist.name == "custom":
            params["__data__"] = data
        meta = self.meta[node.id]
        value, params = _align_dist(dist, self.value(node.id, data), params)
        if meta["censored"] is not None:
            lp = CENSORED.log_likelihood(meta["censored"], value, dist, params)
        else:
            lp = dist.logpdf(value, params)
        return self.apply_obs_meta(lp, meta, reduce)

    def meas_obs_term(self, node, val, data):
        """Measurable-lifted observation with its change-of-measure
        Jacobian: x = A^-1 y (matmul) or (y - b) / a (affine)."""
        dist, params = self._target(node, val)
        value = self.value(node.id, data)
        kind, *args = self.meas[node.id]
        if kind == "solved":
            x, meas_jac = args
        elif kind == "matmul":
            x, meas_jac = _solve_lift(val(args[0]), value)
        else:
            a, b = (val(v) for v in args)
            value_a, b_a, a_a = _align([value, b, a])
            x = (value_a - b_a) / a_a
            meas_jac = -xm.event_sum(torch.log(torch.abs(a)))
        x, params = _align_dist(dist, x, params)
        lp, jac = _align([self.apply_obs_meta(dist.logpdf(x, params),
                                              self.meta[node.id]), meas_jac])
        return lp + jac


def _solve_lift(a, value):
    """x = A^-1 y and the Jacobian -log|det A| of a matmul lift."""
    if value.ndim - 1 == 1:
        x = torch.linalg.solve(a, value.unsqueeze(-1)).squeeze(-1)
    else:
        x = torch.linalg.solve(a, value)
    return x, -torch.log(torch.abs(torch.linalg.det(a)))


def _make_logp(graph: _Graph, pm: PointMap, pointwise: bool = False,
               part: str = "all"):
    """``part``: "all", "prior" (the free RVs' terms: a normalized density
    in unconstrained space) or "likelihood" (the obs/meas_obs terms);
    prior + likelihood == all, term by term. ``pointwise`` returns
    {obs_id: per-datapoint log-likelihood (C, ...)}, obs not reduced."""
    if part not in ("all", "prior", "likelihood"):
        raise ValueError(f"part must be all|prior|likelihood, got {part!r}")
    ir = graph.ir
    node_ids = sorted(ir.nodes)  # deterministic term order

    def logp(flat, data=None):
        zmap = pm.unpack(flat)
        data = graph.data if data is None else _device_value(data, flat.device)
        _, val = graph.resolver(zmap, data)
        total = flat.new_zeros(flat.shape[:1])
        terms = {}
        for nid in node_ids:
            node = ir.nodes[nid]
            tag = node.op[0]
            if tag in ("obs", "meas_obs"):
                if part == "prior" or node.op[-1].get("likelihood", True) is False:
                    continue
                if tag == "obs":
                    term = graph.obs_term(node, val, data, reduce=not pointwise)
                else:
                    term = graph.meas_obs_term(node, val, data)
            elif (tag == "rv" and nid in graph.free_ids and part != "likelihood"
                  and not pointwise):
                term = graph.rv_prior_term(node, zmap, val)
            else:
                continue
            if pointwise:
                terms[nid] = term
            else:
                total = total + xm.event_sum(term)
        return terms if pointwise else total

    return logp


def _make_value_and_grad(logp):
    def value_and_grad(flat, data=None):
        with torch.enable_grad():
            x = flat.detach().requires_grad_(True)
            lp = logp(x, data)
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
    replay). CPU tensors take the eager path.

    Without ``data`` the graph reads the model's own data as captured
    constants. With a ``DeviceData`` every data tensor has a static
    input buffer of its own, keyed with the flat input on the shapes and
    dtypes of all of them, and filled with ``copy_`` before a replay
    whenever the call passes another tensor (or one changed in place)
    than the last one copied there."""

    def __init__(self, vag):
        self.eager = vag
        self.graphs = {}

    def __call__(self, flat, data=None):
        if flat.device.type != "cuda":
            return self.eager(flat, data)
        leaves = [] if data is None else data.leaves()
        key = (tuple(flat.shape), flat.dtype, flat.device,
               tuple((tuple(t.shape), t.dtype) for t in leaves))
        if key not in self.graphs:
            self.graphs[key] = self._capture(flat, data)
        x, bufs, sources, lp, g, graph = self.graphs[key]
        x.copy_(flat)
        for i, (buf, t) in enumerate(zip(bufs, leaves)):
            if sources[i] is None or sources[i][0] is not t or sources[i][1] != t._version:
                buf.copy_(t)
                # holding the source keeps its identity from being reused
                sources[i] = (t, t._version)
        graph.replay()
        return lp.clone(), g.clone()

    def _capture(self, flat, data):
        x = flat.detach().clone()
        bufs = [] if data is None else [t.clone() for t in data.leaves()]
        arg = None if data is None else data.with_leaves(bufs)
        stream = torch.cuda.current_stream(flat.device)
        side = torch.cuda.Stream(device=flat.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            for _ in range(2):  # warm autograd and the allocator first
                self.eager(x, arg)
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            lp, g = self.eager(x, arg)
        return x, bufs, [None] * len(bufs), lp, g, graph


def compile_logp(ir: IR, *, ncp: bool = True, rewritten: bool = False,
                 device=None) -> CompiledModel:
    """Rewrite + compile an IR into a CompiledModel on ``device``
    (default ``"cuda"``)."""
    dev = prepare_device(device)
    rw = ir if rewritten else rewrite.apply(ir, ncp=ncp)
    pm = PointMap.build(rw)
    graph = _Graph(rw, pm, dev, rw.data)
    graph.check_callables(pm)
    logp = _make_logp(graph, pm)
    vag = _make_value_and_grad(logp)
    return CompiledModel(ir=rw, pm=pm, ncp_info=rw.ncp_info, logp=logp,
                         value_and_grad=(GraphedValueAndGrad(vag)
                                         if graph.capturable else vag),
                         device=dev, data=rw.data)


def partial_logp(model: CompiledModel, part: str) -> Callable:
    """Prior-only or likelihood-only log-density, (C, d) -> (C,), on the
    same PointMap and rewritten IR as ``model.logp``: the two parts sum
    to the full log-density at every flat point."""
    graph = _Graph(model.ir, model.pm, model.device, model.data)
    return _make_logp(graph, model.pm, part=part)


def compile_pointwise(ir: IR, *, ncp: bool = True, device=None) -> Callable:
    """Pointwise log-likelihood for WAIC/LOO: (C, d) flat ->
    {obs_id: (C, ...) per-observation log-likelihood}."""
    dev = prepare_device(device)
    rw = rewrite.apply(ir, ncp=ncp)
    pm = PointMap.build(rw)
    return _make_logp(_Graph(rw, pm, dev, rw.data), pm, pointwise=True)


def constrainer(ir: IR, pm: PointMap, device, data=None) -> Callable:
    """``fn((N, d) flat) -> {name: (N, *shape)}``: constrained values with
    NCP reconstruction, the constants moved to ``device`` once. ``data``
    overrides ``ir.data``."""
    graph = _Graph(ir, pm, device, ir.data if data is None else data)

    def constrain(flat):
        resolve, _ = graph.resolver(pm.unpack(flat), graph.data)
        n = flat.shape[0]
        out = {}
        for e in pm.entries:
            v = resolve(e.id)
            out[e.id] = v.expand((n,) + tuple(v.shape[1:])) if v.ndim else v.expand(n)
        return out

    return constrain


def constrain_flat(ir: IR, pm: PointMap, flat, data=None) -> dict:
    """(N, d) flat -> {name: (N, *shape)} constrained values with NCP
    reconstruction. ``data`` overrides ``ir.data``."""
    return constrainer(ir, pm, flat.device, data)(flat)


# the JAX package's name for the compile of a sampler's model
compile_for_sampling = compile_logp
