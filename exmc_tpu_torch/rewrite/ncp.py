"""Automatic non-centered parameterization (``exmc_tpu/rewrite/ncp.py``).

A free RV ``x ~ Normal(mu, sigma_ref)`` whose scale is a reference (and
whose mu is a reference or a scalar constant) becomes
``x ~ Normal(0, 1)`` with ``ir.ncp_info[x] = {"mu": mu, "sigma":
sigma_ref}``; the compiler reconstructs ``mu + sigma * z`` wherever
``x`` is referenced. The GaussianRandomWalk kind of the JAX pass has no
counterpart yet, since the port has no GaussianRandomWalk (ROADMAP §1
item 8).
"""

from dataclasses import replace

from exmc_tpu_torch.dists.base import get as get_dist
from exmc_tpu_torch.dists.continuous import NORMAL
from exmc_tpu_torch.ir import IR, Node, observed_target_ids


def non_centered_parameterization(ir: IR) -> IR:
    observed = observed_target_ids(ir)
    nodes = dict(ir.nodes)
    ncp_info = dict(ir.ncp_info)
    for nid, node in ir.nodes.items():
        if node.op[0] != "rv" or nid in observed or len(node.op) != 3:
            continue
        _, dist, params = node.op
        if get_dist(dist).name != "normal":
            continue
        mu, sigma = params.get("mu"), params.get("sigma")
        if isinstance(sigma, str) and (
            isinstance(mu, str) or not hasattr(mu, "__len__")
        ):
            nodes[nid] = Node(
                id=nid,
                op=("rv", NORMAL, {"mu": 0.0, "sigma": 1.0}),
                deps=(),
                shape=node.shape,
                dtype=node.dtype,
            )
            ncp_info[nid] = {"mu": mu, "sigma": sigma}
    return replace(ir, nodes=nodes, ncp_info=ncp_info)
