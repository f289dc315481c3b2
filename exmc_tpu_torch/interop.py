"""Carrying a model and its sampler tuning over from the JAX package.

A PPL has no weights: what crosses over is the model (its IR) and the
tuning a run produced. Both work on plain data, so this module imports
nothing of the JAX package: ``ir_from_reference`` reads the reference
IR by duck typing (nodes with ``id``/``op``/``deps``/``shape``;
distributions and transforms by their ``.name``).
"""

import numpy as np
import torch

from exmc_tpu_torch import transforms as tf
from exmc_tpu_torch.config import prepare_device
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
    return tf.get(t.name)


def _op(op):
    tag = op[0]
    if tag == "rv":
        out = ("rv", get_dist(op[1].name if hasattr(op[1], "name") else op[1]),
               _plain(op[2]))
        return out + (_transform(op[3]),) if len(op) == 4 else out
    if tag == "det":
        return ("det", op[1], _plain(op[2]))
    return (tag,) + tuple(_plain(x) for x in op[1:])


def ir_from_reference(ir) -> IR:
    """The port's IR of a JAX-package ``IR`` (raw or rewritten): the same
    node ids, ops, deps, shapes and NCP info, with each distribution
    mapped by name to the port's registry and arrays as numpy."""
    nodes = {
        nid: Node(id=n.id, op=_op(n.op), deps=tuple(n.deps),
                  shape=None if n.shape is None else tuple(n.shape),
                  dtype=n.dtype)
        for nid, n in ir.nodes.items()
    }
    return IR(nodes=nodes, outputs=tuple(ir.outputs),
              ncp_info=_plain(dict(ir.ncp_info)),
              data=None if ir.data is None else np.asarray(ir.data))


def tuning_from_numpy(step_size, inv_mass, device=None):
    """(eps (C,), Metric) from the numpy ``stats["step_size"]`` (C,) and
    ``stats["inv_mass"]`` (C, d) of a JAX-package run, on ``device``."""
    dev = prepare_device(device)
    eps = torch.as_tensor(np.asarray(step_size, np.float32), device=dev)
    inv = torch.as_tensor(np.asarray(inv_mass, np.float32), device=dev)
    return eps, make_metric(inv)
