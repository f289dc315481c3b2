"""PointMap: the layout of the flat unconstrained vector
(``exmc_tpu/point_map.py``).

Free RVs are the RV nodes no observation targets, sorted by id. Each
entry carries its (offset, length, shapes, transform); the unconstrained
length differs from the constrained size for the shape-changing
transforms. ``unpack`` cuts a (C, d) batch of flat points into views of
shape (C, *ushape); ``pack`` and the ``to_*`` helpers go the other way
and to and from constrained values, all with the leading batch axis.
"""

from dataclasses import dataclass

import numpy as np
import torch

from exmc_tpu_torch import transforms as tf
from exmc_tpu_torch.config import default_dtype
from exmc_tpu_torch.dists.base import get as get_dist
from exmc_tpu_torch.ir import IR, free_rv_nodes


@dataclass(frozen=True)
class Entry:
    id: str
    offset: int
    length: int
    shape: tuple                 # constrained event shape
    ushape: tuple                # unconstrained event shape
    transform: object = None     # name (str), Transform instance, or None


def _infer_shape(node):
    """Event shape: declared node.shape, else the constant mean of an
    MvNormal or concentration of a Dirichlet, else broadcast of the
    constant array params, else scalar. GaussianRandomWalk, LKJCholesky
    and ZeroSumNormal must declare it."""
    if node.shape is not None:
        return tuple(node.shape)
    name = get_dist(node.op[1]).name
    params = node.op[2]
    for dist, key in (("mv_normal", "mu"), ("dirichlet", "alpha")):
        if name == dist and not isinstance(params.get(key), str):
            return tuple(np.asarray(params[key]).shape)
    for dist, label in (("gaussian_random_walk", "GaussianRandomWalk"),
                        ("lkj_cholesky", "LKJCholesky shape=(d, d)"),
                        ("zero_sum_normal", "ZeroSumNormal shape=(K,)")):
        if name == dist:
            raise ValueError(f"{label} RV {node.id!r} requires an explicit shape")
    shapes = [
        np.asarray(v).shape
        for v in params.values()
        if not isinstance(v, (str, list, tuple, dict))
    ]
    shapes = [s for s in shapes if s]
    if shapes:
        return tuple(np.broadcast_shapes(*shapes))
    return ()


@dataclass(frozen=True)
class PointMap:
    entries: tuple
    size: int

    @staticmethod
    def build(ir: IR) -> "PointMap":
        entries = []
        offset = 0
        for node in free_rv_nodes(ir):
            transform = node.op[3] if len(node.op) == 4 else None
            shape = _infer_shape(node)
            ushape = tf.get(transform).unconstrained_shape(shape)
            length = int(np.prod(ushape)) if ushape else 1
            entries.append(Entry(id=node.id, offset=offset, length=length,
                                 shape=shape, ushape=tuple(ushape),
                                 transform=transform))
            offset += length
        return PointMap(entries=tuple(entries), size=offset)

    def entry(self, node_id: str) -> Entry:
        for e in self.entries:
            if e.id == node_id:
                return e
        raise KeyError(node_id)

    def unpack(self, flat) -> dict:
        """(C, d) flat unconstrained -> {id: (C, *ushape) view}. One split
        (one backward node) rather than a slice per entry, each of whose
        backward would fill a whole (C, d) gradient."""
        c = flat.shape[0]
        parts = torch.split(flat, [e.length for e in self.entries], dim=1)
        return {e.id: part.reshape((c,) + e.ushape)
                for e, part in zip(self.entries, parts)}

    def pack(self, zmap: dict):
        """{id: (N, *ushape) unconstrained} -> (N, d) flat."""
        parts = [torch.as_tensor(zmap[e.id], dtype=default_dtype()).reshape(-1, e.length)
                 for e in self.entries]
        if not parts:
            return torch.zeros((1, 0), dtype=default_dtype())
        return torch.cat(parts, dim=1)

    def to_constrained(self, flat) -> dict:
        """(N, d) flat -> {id: (N, *shape)} through each entry's transform
        (NCP reconstruction is the compiler's, on top of this)."""
        return {e.id: tf.get(e.transform).forward(z)
                for e, z in zip(self.entries, self.unpack(flat).values())}

    def to_unconstrained(self, xmap: dict):
        """{id: (N, *shape) constrained} -> (N, d) flat through the inverse
        transforms."""
        return self.pack({
            e.id: tf.get(e.transform).inverse(
                torch.as_tensor(xmap[e.id], dtype=default_dtype()))
            for e in self.entries})
