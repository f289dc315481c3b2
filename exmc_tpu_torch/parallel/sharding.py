"""Mesh and sharding primitives over ``torch.distributed``
(``exmc_tpu/parallel/sharding.py``).

Axes, as in the JAX package:
    "dp" — chain parallelism: each rank runs its own block of chains;
    "sp" — data (likelihood) parallelism: each rank scores its block of
           the observation rows and one ``all_reduce`` a gradient
           evaluation combines them.

JAX runs one program over a device mesh and GSPMD turns every
cross-chain reduction into a collective. The port runs one process per
device (SPMD under ``torch.distributed``), each holding its own chains
and rows. Ranks are laid out row-major, as the JAX package's
``devices.reshape(dp, sp)``: rank = i_dp * sp + i_sp. Every collective
is an ``all_reduce`` (a sum) or a ``broadcast``: the two that gloo also
runs on CUDA tensors, so two ranks sharing one card (gloo: NCCL refuses
two ranks on one GPU) run the same code as one rank per card (NCCL). A
gather is an ``all_reduce`` of a zero-padded tensor. Without a process
group (one rank) every collective is the identity.

The collectives run outside the CUDA graph of the model's value-and-grad
(``compiler.GraphedValueAndGrad``): gloo cannot be captured. Under gloo a
collective of CUDA tensors goes through the host (a device-to-host copy
and back); ``AxisGroup.host_staged`` counts those, apart from the
samplers' ``host_syncs``.
"""

import numpy as np
import torch
import torch.distributed as dist

from exmc_tpu_torch.compiler import DeviceData
from exmc_tpu_torch.config import prepare_device


def _world():
    """(world size, rank) of the default process group, (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class AxisGroup:
    """The ranks along one mesh axis that share this rank's index on the
    other axis: ``ranks`` (global ranks in axis order), this rank's
    ``index`` among them and the process group. Without a group (one
    rank, no process group) every collective is the identity; a process
    group of one rank runs them, so that a one-rank NCCL group exercises
    its backend. ``host_staged`` counts the collectives whose CUDA
    tensors gloo staged through the host."""

    def __init__(self, ranks, index, group, device):
        self.ranks = list(ranks)
        self.index = index
        self.group = group
        self.device = device
        self._nccl = group is not None and dist.get_backend(group) == "nccl"
        self.host_staged = 0

    def _count_staged(self, t):
        if not self._nccl and t.device.type == "cuda":
            self.host_staged += 1

    @property
    def size(self):
        return len(self.ranks)

    def _reduce(self, t):
        if self._nccl and t.device.type != "cuda":
            buf = t.to(self.device)
            dist.all_reduce(buf, group=self.group)
            t.copy_(buf)
        else:
            self._count_staged(t)
            dist.all_reduce(t, group=self.group)

    def psum(self, *tensors):
        """The sums of ``tensors`` over the axis, as a tuple, in one
        ``all_reduce`` of their concatenation; without a group they come
        back as they are."""
        if self.group is None:
            return tensors
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self._reduce(flat)
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].reshape(t.shape))
            i += t.numel()
        return tuple(out)

    def broadcast(self, t, src=0):
        """``t`` of the rank at axis position ``src``, in place on every
        rank; returns ``t``."""
        if self.group is not None:
            self._count_staged(t)
            dist.broadcast(t, src=self.ranks[src], group=self.group)
        return t

    def block(self, n, what="rows"):
        """The slice of this rank's block of ``n`` rows split evenly
        over the axis."""
        if n % self.size != 0:
            raise ValueError(f"{what} ({n}) not divisible by the axis size "
                             f"({self.size})")
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)

    def gather_rows(self, x):
        """Every rank's (k, ...) block concatenated along dim 0, in axis
        order, on every rank: an ``all_reduce`` of a zero-padded tensor
        (on the host under gloo). numpy in, numpy out; a tensor comes
        back on its device."""
        if self.group is None:
            return x
        as_numpy = not torch.is_tensor(x)
        t = torch.as_tensor(np.asarray(x)) if as_numpy else x
        dtype = t.dtype
        if dtype == torch.bool:
            t = t.to(torch.uint8)
        self._count_staged(t)  # under gloo the gather runs on the host
        where = self.device if self._nccl else torch.device("cpu")
        k = t.shape[0]
        full = torch.zeros((k * self.size,) + tuple(t.shape[1:]), dtype=t.dtype,
                           device=where)
        full[self.index * k:(self.index + 1) * k] = t.to(where)
        self._reduce(full)
        full = full.to(dtype)
        if as_numpy:
            return full.cpu().numpy()
        return full.to(x.device)


class Mesh:
    """A (dp, sp) layout of the process group's ranks. ``shape`` is
    {"dp": .., "sp": ..} as the JAX mesh's; ``axis(name)`` gives this
    rank's ``AxisGroup`` along it; ``device`` is the rank's device.

    Every rank must build the same meshes in the same order: each builds
    every group of the layout (``torch.distributed.new_group``)."""

    def __init__(self, dp, sp, device):
        world, rank = _world()
        if dp * sp != world:
            raise ValueError(f"dp({dp}) * sp({sp}) != {world} ranks")
        self.shape = {"dp": dp, "sp": sp}
        self.device = device
        i_dp, i_sp = divmod(rank, sp)
        self._axes = {}
        lines = {
            "dp": [[i * sp + j for i in range(dp)] for j in range(sp)],
            "sp": [[i * sp + j for j in range(sp)] for i in range(dp)],
        }
        mine = {"dp": (i_sp, i_dp), "sp": (i_dp, i_sp)}
        grouped = dist.is_available() and dist.is_initialized()
        for name, groups in lines.items():
            line, index = mine[name]
            handle = None
            for j, ranks in enumerate(groups):
                if not grouped or (len(ranks) == 1 and world > 1):
                    continue
                g = (dist.group.WORLD if len(ranks) == world
                     else dist.new_group(ranks))
                if j == line:
                    handle = g
            self._axes[name] = AxisGroup(groups[line], index, handle, device)

    def axis(self, name):
        return self._axes[name]

    @property
    def host_staged(self):
        """Collectives staged through the host so far, over both axes."""
        return sum(a.host_staged for a in self._axes.values())


def make_mesh(n_devices=None, dp=None, sp=1, device=None):
    """Build a (dp, sp) mesh over the process group's ranks (one rank
    when no group is initialized). ``n_devices`` defaults to the world
    size and must equal it; ``device`` is this rank's device (default:
    the current CUDA device)."""
    world, _ = _world()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has "
                         f"{world} ranks (one device per rank)")
    if dp is None:
        dp = n_devices // sp
    if dp * sp != n_devices:
        raise ValueError(f"dp({dp}) * sp({sp}) != {n_devices}")
    dev = prepare_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dp, sp, dev)


def _data_rows(x, rows):
    """Rows ``rows`` of the observation data: axis 0 of a raw array,
    axis 1 of a ``DeviceData`` leaf (its axis 0 is the chain axis of 1)."""
    if isinstance(x, DeviceData):
        return x.with_leaves([t[:, rows] for t in x.leaves()])
    return x[rows]


def _num_rows(x):
    if isinstance(x, DeviceData):
        return x.leaves()[0].shape[1]
    return x.shape[0]


def make_data_parallel_vag(model, mesh):
    """Build ``vag(q, data_shard) -> (logp, grad)`` over the "sp" axis.

    Each rank scores its row shard (``shard_data``) through the
    compiler's data channel, ``model.value_and_grad(q, shard)``; the
    value and gradient are summed over "sp" in one ``all_reduce``. The
    prior terms were then counted sp times: the (sp - 1) extra copies are
    subtracted, the prior coming from an empty shard (every obs term of
    zero rows is 0). Requires obs terms additive over data rows and the
    data registered with ``Builder.data``, as in the JAX package. Every
    rank along "sp" gets the same bits."""
    axis = mesh.axis("sp")

    def vag(q, data):
        shard = model.device_data(data)
        v, g = axis.psum(*model.value_and_grad(q, shard))
        if axis.size == 1:
            return v, g
        pv, pg = model.value_and_grad(q, _data_rows(shard, slice(0, 0)))
        extra = float(axis.size - 1)
        return v - extra * pv, g - extra * pg

    return vag


def shard_data(mesh, data):
    """This rank's block of the (n, ...) data rows over "sp" (an array,
    or a ``DeviceData`` whose every leaf has n rows); n must divide
    evenly."""
    axis = mesh.axis("sp")
    return _data_rows(data, axis.block(_num_rows(data), "data rows"))


def data_parallel_vag(model, mesh, data):
    """Closure form of :func:`make_data_parallel_vag`: returns
    (vag_fn(q) -> (logp, grad), this rank's data shard)."""
    vag = make_data_parallel_vag(model, mesh)
    sharded = model.device_data(shard_data(mesh, data))
    return (lambda q: vag(q, sharded)), sharded


def shard_chains(mesh, *arrays):
    """This rank's block of each chain-major array over "dp", as a
    tensor on the mesh's device (a tuple, as in the JAX package)."""
    axis = mesh.axis("dp")
    return tuple(torch.as_tensor(a[axis.block(a.shape[0], "chains")],
                                 device=mesh.device)
                 for a in arrays)
