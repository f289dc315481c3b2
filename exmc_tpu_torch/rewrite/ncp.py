"""Automatic non-centered parameterization (``exmc_tpu/rewrite/ncp.py``).

A free RV ``x ~ Normal(mu, sigma_ref)`` whose scale is a reference (and
whose mu is a reference or a scalar constant) becomes
``x ~ Normal(0, 1)`` with ``ir.ncp_info[x] = {"mu": mu, "sigma":
sigma_ref}``; the compiler reconstructs ``mu + sigma * z`` wherever
``x`` is referenced.

A free ``s ~ GaussianRandomWalk(sigma_ref)`` of length T becomes
``z ~ Normal(0, 1)^T`` with ``kind: "grw"``: the compiler reconstructs
``s = sigma * cumsum(z)``, and from T = ``SPECTRAL_MIN_T`` on
(``spectral: True``) the sampled coordinates are ``w`` with
``z = V w``, V the orthonormal eigenbasis of the cumsum gram
(``compiler._grw_spectral_basis``).
"""

from dataclasses import replace

from exmc_tpu_torch.dists.base import get as get_dist
from exmc_tpu_torch.dists.continuous import NORMAL
from exmc_tpu_torch.ir import IR, Node, observed_target_ids

# GRW latents at least this long also get the spectral rotation.
SPECTRAL_MIN_T = 64


def _standard_normal(node):
    return Node(id=node.id, op=("rv", NORMAL, {"mu": 0.0, "sigma": 1.0}),
                deps=(), shape=node.shape, dtype=node.dtype)


def non_centered_parameterization(ir: IR) -> IR:
    observed = observed_target_ids(ir)
    nodes = dict(ir.nodes)
    ncp_info = dict(ir.ncp_info)
    for nid, node in ir.nodes.items():
        if node.op[0] != "rv" or nid in observed or len(node.op) != 3:
            continue
        _, dist, params = node.op
        name = get_dist(dist).name
        mu, sigma = params.get("mu"), params.get("sigma")
        if name == "gaussian_random_walk":
            if isinstance(sigma, str):
                nodes[nid] = _standard_normal(node)
                t_len = node.shape[-1] if node.shape else 0
                ncp_info[nid] = {"mu": 0.0, "sigma": sigma, "kind": "grw",
                                 "spectral": t_len >= SPECTRAL_MIN_T}
        elif name == "normal" and isinstance(sigma, str) and (
            isinstance(mu, str) or not hasattr(mu, "__len__")
        ):
            nodes[nid] = _standard_normal(node)
            ncp_info[nid] = {"mu": mu, "sigma": sigma}
    return replace(ir, nodes=nodes, ncp_info=ncp_info)
