"""PointMap: the layout of the flat unconstrained vector
(``exmc_tpu/point_map.py``).

Free RVs are the RV nodes no observation targets, sorted by id. Each
entry carries its (offset, length, shapes, transform); ``unpack`` cuts a
(C, d) batch of flat points into views of shape (C, *ushape).
"""

from dataclasses import dataclass

import numpy as np
import torch

from exmc_tpu_torch import transforms as tf
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
    """Event shape: declared node.shape, else broadcast of the constant
    array params, else scalar. A GaussianRandomWalk must declare it."""
    if node.shape is not None:
        return tuple(node.shape)
    if get_dist(node.op[1]).name == "gaussian_random_walk":
        raise ValueError(
            f"GaussianRandomWalk RV {node.id!r} requires an explicit shape")
    params = node.op[2]
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

    def unpack(self, flat) -> dict:
        """(C, d) flat unconstrained -> {id: (C, *ushape) view}. One split
        (one backward node) rather than a slice per entry, each of whose
        backward would fill a whole (C, d) gradient."""
        c = flat.shape[0]
        parts = torch.split(flat, [e.length for e in self.entries], dim=1)
        return {e.id: part.reshape((c,) + e.ushape)
                for e, part in zip(self.entries, parts)}
