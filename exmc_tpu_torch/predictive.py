"""Prior and posterior predictive sampling (``exmc_tpu/predictive.py``).

* ``prior_samples``: a topological sort of the model graph, then a
  forward draw of every RV and det node. The JAX package vmaps one
  point's draw over the draws; the port draws all of them at once, with
  the draw axis as the chain axis of the compiler's batched values, so
  det callables apply one point at a time as they do in a log-density.
* ``posterior_predictive``: for each observation, the target's
  parameters resolved from every posterior draw at once, then one draw
  of the likelihood per posterior draw (a measurable lift applied
  forward).
* ``ppc_pvalue``: the posterior predictive p-value of a statistic.

Randomness comes from a ``torch.Generator`` on the model's device seeded
from ``seed``, so the draws differ from JAX's draw for draw and agree in
distribution.
"""

import numpy as np
import torch

from exmc_tpu_torch import rewrite
from exmc_tpu_torch.compiler import (
    OBS_DATA_KEY,
    CompiledModel,
    _align,
    _align_dist,
    _apply_det,
    _base_data,
    _const,
    _Graph,
    _map_params,
    _matmul,
    _resolve_value,
    compile_logp,
)
from exmc_tpu_torch.config import default_dtype, prepare_device
from exmc_tpu_torch.dists.base import get as get_dist
from exmc_tpu_torch.ir import IR
from exmc_tpu_torch.model_comparison import _as_flat_draws
from exmc_tpu_torch.point_map import PointMap, _infer_shape


def _topo_order(ir: IR):
    """Kahn's topological sort over node deps, ties broken by id."""
    indeg = {nid: 0 for nid in ir.nodes}
    children = {nid: [] for nid in ir.nodes}
    for nid, node in ir.nodes.items():
        for dep in node.deps:
            if dep in ir.nodes:
                indeg[nid] += 1
                children[dep].append(nid)
    queue = sorted([nid for nid, k in indeg.items() if k == 0])
    order = []
    while queue:
        nid = queue.pop(0)
        order.append(nid)
        for ch in sorted(children[nid]):
            indeg[ch] -= 1
            if indeg[ch] == 0:
                queue.append(ch)
    if len(order) != len(ir.nodes):
        raise ValueError("model graph has a cycle")
    return order


def _tensor_leaves(params):
    out = []
    for k, v in params.items():
        if k == "components":
            continue
        if isinstance(v, dict):
            out += _tensor_leaves(v)
        elif isinstance(v, (list, tuple)):
            for p in v:
                out += _tensor_leaves(p)
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


def _draw(dist, params, n, shape, generator):
    """``n`` draws of ``dist`` whose params carry a leading axis of n (1
    for constants): the params aligned against a (n, *shape) value, and
    a univariate draw's shape broadcast against them, as one point's
    draw broadcasts in JAX."""
    value = torch.empty((n,) + tuple(shape), dtype=default_dtype(),
                        device=generator.device)
    value, params = _align_dist(dist, value, params)
    full = tuple(value.shape)
    if dist.value_event_dims == 0 and dist.name != "mixture":
        full = tuple(torch.broadcast_shapes(full, *(p.shape for p in _tensor_leaves(params))))
    return dist.sample(params, full, generator)


def _point_ndim(v, vm):
    """ndim of one point's value of a raw IR param."""
    if isinstance(v, str):
        return vm[v].ndim - 1 if v in vm else 0
    return np.ndim(v)


def _forward_draw(graph: _Graph, order, n, generator, data):
    """``n`` forward draws of every RV and det node in ``order``:
    {id: (n, *shape)}."""
    ir = graph.ir
    vm = {}

    def val(v):
        if isinstance(v, str):
            return _base_data(data) if v == OBS_DATA_KEY else vm[v]
        return v

    for nid in order:
        node = ir.nodes[nid]
        if node.op[0] == "rv":
            dist = get_dist(node.op[1])
            params = _map_params(graph.params[nid], val)
            x = _draw(dist, params, n, _infer_shape(node), generator)
            tf = node.op[3] if len(node.op) == 4 else None
            tf_name = tf if isinstance(tf, str) else getattr(tf, "name", None)
            if tf_name in ("ordered", "positive_ordered"):
                # an ordered prior restricts an iid dist to the sorted
                # cone; for exchangeable components (scalar params) that
                # is exactly the sorted iid draw
                if any(_point_ndim(p, vm) > 0 for k, p in node.op[2].items()):
                    raise ValueError(
                        f"prior_samples: rv {nid!r} has an ordered transform "
                        "with non-scalar params — components are not "
                        "exchangeable, the sorted-iid forward sample would "
                        "not match the model prior")
                x = torch.sort(x, dim=-1).values
            vm[nid] = x
        elif node.op[0] == "det":
            vm[nid] = _apply_det(nid, node.op[1], [val(a) for a in graph.args[nid]])
    return vm


def prior_samples(ir: IR, num_draws=500, seed=0, data=None, rewritten=False,
                  device=None):
    """Prior predictive: ``num_draws`` forward draws of the whole graph,
    {node_id: (num_draws, *shape)} numpy arrays for every RV and det
    node, on ``device`` (default ``"cuda"``).

    ``rewritten=True`` samples ``ir`` as it is, for an IR already
    rewritten (``CompiledModel.ir``, whose NCP nodes draw their z values
    directly)."""
    dev = prepare_device(device)
    rw = ir if rewritten else rewrite.apply(ir, ncp=False)
    graph = _Graph(rw, PointMap.build(rw), dev, rw.data if data is None else data)
    order = [nid for nid in _topo_order(rw) if rw.nodes[nid].op[0] in ("rv", "det")]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = _forward_draw(graph, order, num_draws, gen, graph.data)
    return {k: v.expand((num_draws,) + tuple(v.shape[1:])).cpu().numpy()
            for k, v in out.items()}


def _obs_shape(node, target):
    value = node.op[2]
    if isinstance(value, (str, dict, tuple)):
        return _infer_shape(target)
    return tuple(np.asarray(value).shape)


def _likelihood_params(model: CompiledModel, flat, data):
    """{obs_id: (dist, params, shape)} of every observation, the target's
    params resolved at the (N, d) flat points (a leading axis of N, 1
    for constants), and its resolver's ``val``."""
    graph = _Graph(model.ir, model.pm, flat.device, data)
    _, val = graph.resolver(model.pm.unpack(flat), graph.data)
    out = {}
    for obs_id, node in sorted(model.ir.nodes.items()):
        if node.op[0] not in ("obs", "meas_obs"):
            continue
        target = model.ir.get_node(node.op[1])
        out[obs_id] = (get_dist(target.op[1]), _map_params(graph.params[target.id], val),
                       _obs_shape(node, target))
    return out, val


def posterior_predictive(ir, trace, seed=0, data=None, ncp=True, device=None):
    """Posterior predictive: for each observation, one draw of its
    likelihood per posterior draw. ``trace`` is the constrained named
    trace of ``sample`` ((chains, draws, ...) arrays).

    Returns {obs_id: (chains, draws, *obs_shape)}."""
    model = ir if isinstance(ir, CompiledModel) else compile_logp(ir, ncp=ncp, device=device)
    if data is None:
        data = model.ir.data
    c, n = np.shape(trace[model.pm.entries[0].id])[:2]
    flat = _as_flat_draws(model, trace)
    lik, val = _likelihood_params(model, flat, data)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    out = {}
    for obs_id, (dist, params, shape) in lik.items():
        draw = _draw(dist, params, c * n, shape, gen)
        node = model.ir.nodes[obs_id]
        if node.op[0] == "meas_obs":
            # the observed quantity is the lift of the target: apply it
            # forward (the log-density inverts it)
            kind, *ops = node.op[3]
            ops = [val(v if isinstance(v, str) else _const(v, model.device)) for v in ops]
            if kind == "matmul":
                draw = _matmul(ops[0], draw)
            elif kind == "affine":
                a, b, draw = _align([ops[0], ops[1], draw])
                draw = a * draw + b
            else:
                raise ValueError(f"unknown measurable op: {kind!r}")
        draw = draw.expand((c * n,) + tuple(draw.shape[1:]))
        out[obs_id] = draw.reshape((c, n) + tuple(draw.shape[1:])).cpu().numpy()
    return out


def ppc_pvalue(ir, trace, stat, data=None, ncp=True, seed=0, obs_id=None,
               device=None):
    """Posterior predictive check: the Bayesian p-value P(T(y_rep) >=
    T(y_obs)) of a statistic ``stat`` (an observation array -> a
    scalar). ``obs_id`` picks the observation when the model has several.
    Returns {"p_value", "observed", "replicated" (per draw), "obs_id"}."""
    reps = posterior_predictive(ir, trace, seed=seed, data=data, ncp=ncp, device=device)
    if obs_id is None:
        if len(reps) != 1:
            raise ValueError(f"model has {len(reps)} obs nodes ({sorted(reps)}); "
                             "pass obs_id=")
        obs_id = next(iter(reps))
    if obs_id not in reps:
        raise ValueError(f"unknown obs node {obs_id!r} ({sorted(reps)})")
    src_ir = ir.ir if isinstance(ir, CompiledModel) else ir
    observed_value = src_ir.nodes[obs_id].op[2]
    if isinstance(observed_value, (str, tuple)):
        observed_value = _resolve_value(observed_value,
                                        data if data is not None else src_ir.data)
    if isinstance(observed_value, dict):
        raise ValueError("ppc_pvalue does not support interval-censored obs values")
    observed_value = np.asarray(observed_value)
    rep = np.asarray(reps[obs_id])
    rep_flat = rep.reshape((-1,) + rep.shape[2:])
    t_obs = float(stat(observed_value))
    t_rep = np.asarray([float(stat(r)) for r in rep_flat])
    return {"p_value": float((t_rep >= t_obs).mean()), "observed": t_obs,
            "replicated": t_rep, "obs_id": obs_id}
