"""Carrying a model and its sampler tuning over from the JAX package.

A PPL has no weights: what crosses over is the model (its IR) and the
tuning a run produced. Both work on plain data, so this module imports
nothing of the JAX package: ``ir_from_reference`` reads the reference
IR by duck typing (nodes with ``id``/``op``/``deps``/``shape``;
distributions and transforms by their ``.name``, a bounded transform
with its bounds). Every distribution and transform, the obs metadata
(censoring, reduce, weight, mask) and ``meas_obs`` carry over. A
callable det node or a ``Custom`` distribution does not: a JAX
callable cannot run on torch tensors, and the IR is refused with an
error naming the node.
"""

import numpy as np
import torch

from exmc_tpu_torch import transforms as tf
from exmc_tpu_torch.config import np_dtype, prepare_device
from exmc_tpu_torch.dists.base import get as get_dist
from exmc_tpu_torch.ir import IR, Node
from exmc_tpu_torch.nuts.leapfrog import make_metric


def _plain(v):
    """Strings, Python numbers and None stay; containers recurse; any
    other array-like (a JAX array) becomes a numpy array."""
    if v is None or isinstance(v, (str, bool, int, float, np.ndarray)):
        return v
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    return np.asarray(v)


def _transform(t):
    if t is None or isinstance(t, str):
        return t
    if t.name in tf.BOUNDED:
        bounds = {"interval": ("lower", "upper"), "lower_bound": ("lower",),
                  "upper_bound": ("upper",)}[t.name]
        return tf.BOUNDED[t.name](*(float(getattr(t, b)) for b in bounds))
    return tf.get(t.name)


def _dist(d, nid):
    name = d if isinstance(d, str) else d.name
    if name == "custom":
        raise ValueError(
            f"node {nid!r}: a Custom distribution holds a JAX callable, which "
            "cannot be carried over; build it with exmc_tpu_torch.dists.Custom "
            "and a torch logpdf")
    return get_dist(name)


def _params(params, nid):
    out = {}
    for k, v in params.items():
        if k == "components":
            out[k] = [_dist(c, nid) for c in v]
        elif k == "params" and isinstance(v, (list, tuple)):
            out[k] = [_params(p, nid) for p in v]
        else:
            out[k] = _plain(v)
    return out


def _op(op, nid):
    tag = op[0]
    if tag == "rv":
        out = ("rv", _dist(op[1], nid), _params(op[2], nid))
        return out + (_transform(op[3]),) if len(op) == 4 else out
    if tag == "det":
        if not isinstance(op[1], str):
            raise ValueError(
                f"det node {nid!r} holds a callable, which cannot be carried "
                "over from the JAX package; use a named det op or rebuild the "
                "node with a torch callable")
        return ("det", op[1], _plain(op[2]))
    return (tag,) + tuple(_plain(x) for x in op[1:])


def ir_from_reference(ir) -> IR:
    """The port's IR of a JAX-package ``IR`` (raw or rewritten): the same
    node ids, ops, deps, shapes and NCP info, with each distribution
    mapped by name to the port's registry and arrays as numpy."""
    nodes = {
        nid: Node(id=n.id, op=_op(n.op, nid), deps=tuple(n.deps),
                  shape=None if n.shape is None else tuple(n.shape),
                  dtype=n.dtype)
        for nid, n in ir.nodes.items()
    }
    return IR(nodes=nodes, outputs=tuple(ir.outputs),
              ncp_info=_plain(dict(ir.ncp_info)),
              data=_plain(ir.data))


def tuning_from_numpy(step_size, inv_mass, device=None, dense=None):
    """(eps (C,), Metric) from the numpy ``stats["step_size"]`` (C,) and
    ``stats["inv_mass"]`` of a JAX-package run, on ``device``: (C, d)
    diagonal, or dense as (C, d, d), or one (d, d) matrix with
    ``dense=True`` (shared by every chain)."""
    dev = prepare_device(device)
    eps = torch.as_tensor(np.asarray(step_size, np_dtype()), device=dev)
    inv = torch.as_tensor(np.asarray(inv_mass, np_dtype()), device=dev)
    if dense is None:
        dense = inv.ndim == 3
    if dense and inv.ndim == 2:
        inv = inv.expand(eps.shape[0], -1, -1).contiguous()
    return eps, make_metric(inv, dense=dense)


def _tensors(x, device):
    """Arrays (in dicts and lists) -> tensors on ``device``."""
    if isinstance(x, dict):
        return {k: _tensors(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tensors(v, device) for v in x)
    if x is None or isinstance(x, (str, bool, int, float)):
        return x
    return torch.as_tensor(np.array(x), device=device)


def fit_from_numpy(fit, device=None):
    """An ADVI or Pathfinder fit of the JAX package (``mu``, ``sigma``,
    and any path buffers: the points ``mu`` (n, d), ``sigma``, the
    curvature histories ``s``, ``y``, ``valid`` and ``gamma``) as tensors
    on ``device``; draws and scalars pass through as they are."""
    dev = prepare_device(device)
    keep = ("draws", "best_iter", "converged_at", "steps_run", "method", "psir")
    return {k: (v if k in keep else _tensors(v, dev)) for k, v in fit.items()}


def ensemble_state_from_numpy(carry, device=None):
    """A ChEES / SNAPER / MEADS carry of the JAX package (q, logp, grad,
    the dual-averaging state, logT, logT_bar, the Adam moments and count,
    the inverse mass, the per-chain Welford state, SNAPER's principal
    component, MEADS's momentum u), its arrays as numpy, as the port's
    carry on ``device``: one group, its tuning state (the dual-averaging
    state, logT, logT_bar, the Adam moments and count, the inverse mass,
    the principal component) with a leading group axis of 1. The PRNG
    keys are dropped: the port's draws come from a generator or are
    injected."""
    from exmc_tpu_torch.nuts.mass_matrix import WelfordState
    from exmc_tpu_torch.nuts.step_size import DualAveragingState

    dev = prepare_device(device)
    out = {}
    for k, v in carry.items():
        if k == "keys":
            continue
        if k == "da":
            out[k] = DualAveragingState(*(_tensors(getattr(v, f), dev)[None]
                                          for f in DualAveragingState._fields))
        elif k == "wf":
            out[k] = WelfordState(*(_tensors(getattr(v, f), dev)
                                    for f in WelfordState._fields))
        elif k in ("q", "logp", "grad", "u"):
            out[k] = _tensors(v, dev)
        else:
            out[k] = _tensors(v, dev)[None]
    return out


def flow_from_numpy(params, device=None):
    """A ``flows.CouplingFlow`` on ``device`` from the JAX package's flow
    parameters (``FlowFit.params``: {"mu", "log_s", "layers": [{"w1",
    "b1", "w2", "b2"}, ...]}, arrays as numpy), computing the same
    flow."""
    from exmc_tpu_torch.flows import CouplingFlow

    dev = prepare_device(device)
    mu = np.asarray(params["mu"])
    layers = params["layers"]
    d, hidden = mu.shape[0], np.asarray(layers[0]["w1"]).shape[1]
    flow = CouplingFlow(d, len(layers), hidden, device=dev)
    with torch.no_grad():
        flow.mu.copy_(torch.as_tensor(np.array(mu)))
        flow.log_s.copy_(torch.as_tensor(np.array(params["log_s"])))
        for k, layer in enumerate(layers):
            for name in ("w1", "b1", "w2", "b2"):
                getattr(flow, name)[k].copy_(torch.as_tensor(np.array(layer[name])))
    return flow


def flow_to_numpy(flow):
    """The inverse of ``flow_from_numpy``: the JAX package's parameter
    layout, as numpy arrays."""
    def arr(t):
        return t.detach().cpu().numpy()

    return {"mu": arr(flow.mu), "log_s": arr(flow.log_s),
            "layers": [{name: arr(getattr(flow, name)[k]) for name in ("w1", "b1", "w2", "b2")}
                       for k in range(flow.num_layers)]}


def ssm_from_numpy(ssm, device=None):
    """A linear-Gaussian state-space model of the JAX package
    (``exmc_tpu.kalman.LGSSM``, or any object with its six fields
    F, Q, h, r, mu0, P0) as the port's ``kalman.LGSSM`` of tensors in
    ``default_dtype()`` on ``device``."""
    from exmc_tpu_torch.config import default_dtype
    from exmc_tpu_torch.kalman import LGSSM

    dev = prepare_device(device)
    return LGSSM(*(torch.as_tensor(np.asarray(getattr(ssm, f)), dtype=default_dtype(),
                                   device=dev) for f in LGSSM._fields))
