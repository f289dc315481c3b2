"""Model IR: model-as-data. The port's own copy of ``exmc_tpu/ir.py``.

An IR is a dict of nodes plus optional observation data and the NCP
metadata filled by the rewrite pass.

Node ops (tuples, first element is the tag):
    ("rv", dist, params)                      free/observed random variable
    ("rv", dist, params, transform)           after attach_default_transforms
    ("obs", target_id, value, meta)           observation of an RV
    ("det", fn, args)                         deterministic node
    ("meas_obs", rv_id, value, op_info, meta) measurable-lifted observation

params: dict name -> array | number | str (a string is a reference to
another node's *constrained* value).
"""

from dataclasses import dataclass, field, replace
from typing import Any, Optional

import numpy as np


@dataclass
class Node:
    id: str
    op: tuple
    deps: tuple = ()
    shape: Optional[tuple] = None
    dtype: Any = None


@dataclass
class IR:
    nodes: dict = field(default_factory=dict)
    outputs: tuple = ()
    ncp_info: dict = field(default_factory=dict)
    data: Any = None

    def add_node(self, node: Node) -> "IR":
        if node.id in self.nodes:
            raise ValueError(f"duplicate node id: {node.id!r}")
        nodes = dict(self.nodes)
        nodes[node.id] = node
        return replace(self, nodes=nodes)

    def get_node(self, node_id: str) -> Node:
        try:
            return self.nodes[node_id]
        except KeyError:
            raise KeyError(f"no node with id {node_id!r}") from None

    def replace_node(self, node: Node) -> "IR":
        nodes = dict(self.nodes)
        nodes[node.id] = node
        return replace(self, nodes=nodes)


def _param_refs(params) -> tuple:
    """String values in params are references to other nodes, except the
    "__obs_data" sentinel."""
    refs = []
    for v in params.values():
        if isinstance(v, str) and v != "__obs_data":
            refs.append(v)
        elif isinstance(v, (list, tuple)):
            refs.extend(x for x in v if isinstance(x, str) and x != "__obs_data")
    return tuple(refs)


def _infer_shape(value):
    return tuple(np.asarray(value).shape)


class Builder:
    """IR construction helpers. All methods are static and functional:
    they take an IR and return a new IR."""

    @staticmethod
    def new_ir() -> IR:
        return IR()

    @staticmethod
    def data(ir: IR, tensor) -> IR:
        """Register observation data, referenced as "__obs_data"."""
        return replace(ir, data=tensor)

    @staticmethod
    def rv(ir: IR, node_id: str, dist, params: dict, *, transform=None,
           shape=None) -> IR:
        """Add a random-variable node. ``transform`` overrides the dist's
        default constraint transform; ``shape`` declares a non-scalar
        event shape."""
        op = ("rv", dist, dict(params)) if transform is None else (
            "rv", dist, dict(params), transform
        )
        node = Node(id=node_id, op=op, deps=_param_refs(params), shape=shape)
        return ir.add_node(node)

    @staticmethod
    def obs(ir: IR, node_id: str, rv_id: str, value, *, likelihood=None,
            weight=None, mask=None, reduce=None, censored=None,
            meta=None) -> IR:
        """Add an observation node with metadata. Adds ``reduce="sum"``
        for non-scalar obs values."""
        m = dict(meta) if meta else {}
        for k, v in (
            ("likelihood", likelihood),
            ("weight", weight),
            ("mask", mask),
            ("reduce", reduce),
            ("censored", censored),
        ):
            if v is not None:
                m[k] = v
        if "reduce" not in m and not isinstance(value, dict) and _infer_shape(value):
            m["reduce"] = "sum"
        node = Node(id=node_id, op=("obs", rv_id, value, m), deps=(rv_id,))
        return ir.add_node(node)

    @staticmethod
    def det(ir: IR, node_id: str, fn, args: list) -> IR:
        """Add a deterministic node: ``fn`` is a name from the compiler's
        det-op table or a callable taking the resolved args.

        A callable sees ONE point, as in the JAX package: the compiler
        applies it with ``torch.func.vmap`` over the chain axis, so
        ``lambda th: th.sum()`` sums a point's own elements and
        ``lambda th: th[idx]`` indexes them. It must be vmap-able (no
        value-dependent shapes, no host reads); one that is not fails
        at compile time naming the node."""
        deps = tuple(a for a in args if isinstance(a, str))
        node = Node(id=node_id, op=("det", fn, tuple(args)), deps=deps)
        return ir.add_node(node)


def _batched(fn):
    """Mark a det callable of the Stan frontend's factor nodes as written
    for the batched values (a leading chain axis, 1 for constants): the
    compiler calls it on the aligned batch, not one point at a time."""
    fn._exmc_batched = True
    return fn


def _is_batched(fn) -> bool:
    return bool(getattr(fn, "_exmc_batched", False))


def observed_target_ids(ir: IR) -> set:
    """RV ids targeted by obs/meas_obs nodes."""
    out = set()
    for node in ir.nodes.values():
        if node.op[0] in ("obs", "meas_obs"):
            out.add(node.op[1])
    return out


def free_rv_nodes(ir: IR) -> list:
    """Free RVs = RV nodes not targeted by any observation, sorted by id
    for a deterministic flat layout."""
    observed = observed_target_ids(ir)
    rvs = [
        n for n in ir.nodes.values() if n.op[0] == "rv" and n.id not in observed
    ]
    return sorted(rvs, key=lambda n: n.id)
