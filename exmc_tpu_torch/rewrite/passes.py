"""Rewrite passes 1-5 (``exmc_tpu/rewrite/passes.py``): pure IR -> IR
functions; each node is rewritten independently."""

from dataclasses import replace

from exmc_tpu_torch.dists.base import get as get_dist
from exmc_tpu_torch.ir import IR, observed_target_ids


def attach_default_transforms(ir: IR) -> IR:
    """("rv", d, p) -> ("rv", d, p, transform) from the dist's default.
    RVs that already carry a transform, and observed RVs, are left
    alone (an observed value never moves, so a transform would only
    add a spurious Jacobian)."""
    observed = observed_target_ids(ir)
    nodes = {}
    for nid, node in ir.nodes.items():
        if node.op[0] == "rv" and len(node.op) == 3 and nid not in observed:
            _, dist, params = node.op
            transform = get_dist(dist).default_transform(params)
            if transform is not None:
                node = replace(node, op=("rv", dist, params, transform))
        nodes[nid] = node
    return replace(ir, nodes=nodes)


def _lift(ir: IR, det_fn: str, make_op_info) -> IR:
    """Lift obs(det(fn(..., rv))) into a measurable observation."""
    nodes = {}
    for nid, node in ir.nodes.items():
        if node.op[0] == "obs":
            _, target_id, value, meta = _canonical_obs(node.op)
            target = ir.nodes.get(target_id)
            if target is not None and target.op[0] == "det" and target.op[1] == det_fn:
                lifted = make_op_info(target.op[2])
                if lifted is not None:
                    rv_id, op_info = lifted
                    node = replace(
                        node,
                        op=("meas_obs", rv_id, value, op_info, meta),
                        deps=(rv_id,),
                    )
        nodes[nid] = node
    return replace(ir, nodes=nodes)


def lift_measurable_matmul(ir: IR) -> IR:
    """obs(det(matmul(A, rv))) -> ("meas_obs", rv, value, ("matmul", A), meta)."""

    def make(args):
        if len(args) == 2 and isinstance(args[1], str):
            return args[1], ("matmul", args[0])
        return None

    return _lift(ir, "matmul", make)


def lift_measurable_affine(ir: IR) -> IR:
    """obs(det(affine(a, b, rv))) -> ("meas_obs", rv, value, ("affine", a, b), meta)."""

    def make(args):
        if len(args) == 3 and isinstance(args[2], str):
            return args[2], ("affine", args[0], args[1])
        return None

    return _lift(ir, "affine", make)


def _canonical_obs(op):
    """obs ops are 4-tuples; accept 3-tuples too."""
    if len(op) == 3:
        return (op[0], op[1], op[2], {})
    return op


def normalize_obs(ir: IR) -> IR:
    """obs -> canonical ("obs", target, value, meta) 4-tuple."""
    nodes = {}
    for nid, node in ir.nodes.items():
        if node.op[0] == "obs":
            node = replace(node, op=_canonical_obs(node.op))
        nodes[nid] = node
    return replace(ir, nodes=nodes)


_META_DEFAULTS = {"likelihood": True, "weight": 1.0, "mask": None, "reduce": None}


def populate_obs_metadata(ir: IR) -> IR:
    """Fill meta defaults likelihood/weight/mask/reduce."""
    nodes = {}
    for nid, node in ir.nodes.items():
        if node.op[0] in ("obs", "meas_obs"):
            meta = dict(_META_DEFAULTS)
            meta.update(node.op[-1])
            node = replace(node, op=node.op[:-1] + (meta,))
        nodes[nid] = node
    return replace(ir, nodes=nodes)
