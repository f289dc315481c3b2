"""One leaf of the NUTS tree's subtree build: the plain PyTorch version
and the hand-written CUDA kernel that does it in one launch
(``csrc/nuts_leaf.cu``).

A leaf finishes a leapfrog step from the model's value-and-grad, weighs
the new point, updates the subtree's multinomial proposal, and writes a
checkpoint (even leaves) or runs the U-turn checks of every
sub-trajectory that ends there (odd leaves); a chain that is not live
keeps its state (``keep``). ``tree._build_subtree`` takes the kernel for
CUDA tensors under a diagonal metric (``uses_kernel``), and the plain
version on the CPU and for a dense metric.

The plain version issues ~80 small operations a leaf, which on the card
bounds a NUTS fit by the host's issue of them. The kernel keeps the
subtree's state in buffers that it updates in place (``LeafKernel``):
a leaf is one launch after the value-and-grad, and one flag that says
whether any chain is still live, which the host reads once.
"""

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from exmc_tpu_torch import _build
from exmc_tpu_torch.config import DIVERGENCE_THRESHOLD
from exmc_tpu_torch.nuts.leapfrog import kinetic_energy, leapfrog, velocity, velocity_rows
from exmc_tpu_torch.nuts.masked import keep


class Subtree(NamedTuple):
    n: torch.Tensor           # leaves built (C,) int32
    z: torch.Tensor           # far boundary of the subtree
    r: torch.Tensor
    g: torch.Tensor
    r_first: torch.Tensor     # momentum at the leaf next to the old trajectory
    z_prop: torch.Tensor
    logp_prop: torch.Tensor
    g_prop: torch.Tensor
    joint_prop: torch.Tensor
    lsw: torch.Tensor         # subtree multinomial log-sum-weight
    rho: torch.Tensor         # subtree momentum sum
    sum_accept: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor


def _popcount(n):
    return bin(n).count("1")


def _ctz(n):
    return (n & -n).bit_length() - 1


def checked_slots(n):
    """(idx_min, idx_max): the checkpoint slots whose sub-trajectories end
    at odd leaf ``n``."""
    idx_max = _popcount(n) - 1
    return idx_max - _ctz(n + 1) + 1, idx_max


def _dots(a, b):
    return torch.sum(a * b, dim=-1)


def iterative_uturn_check(metric, r_new, rho_through, ckpt, idx_min, idx_max):
    """U-turn check of every power-of-two sub-trajectory that ends at the
    current (odd) leaf: checkpoint slots idx_min..idx_max (host ints).

    For the sub-trajectory closing at slot i, its midpoint is the
    checkpoint at slot i+1, so Stan's extended checks are available:
      (a) full:  rho[s..n],             boundaries (r_s, r_n)
      (b) left:  rho[s..mid-1] + r_mid, boundaries (r_s, r_mid)
      (c) right: rho[mid..n] + r_{mid-1}, boundaries (r_{mid-1}, r_n)
    At i == idx_max (the leaf pair) all three collapse to (a)."""
    v_new = velocity(metric, r_new).unsqueeze(1)
    rho_n = rho_through.unsqueeze(1)
    ck_r = ckpt[:, idx_min:idx_max + 1, 0]
    ck_rho = ckpt[:, idx_min:idx_max + 1, 1]
    rho_sub = rho_n - ck_rho + ck_r
    turn = ((_dots(rho_sub, velocity_rows(metric, ck_r)) <= 0.0)
            | (_dots(rho_sub, v_new) <= 0.0)).any(-1)
    if idx_max > idx_min:
        lo_r = ckpt[:, idx_min:idx_max, 0]
        lo_rho = ckpt[:, idx_min:idx_max, 1]
        nx_r = ckpt[:, idx_min + 1:idx_max + 1, 0]
        nx_rho = ckpt[:, idx_min + 1:idx_max + 1, 1]
        nx_prev = ckpt[:, idx_min + 1:idx_max + 1, 2]
        rho_left = nx_rho - lo_rho + lo_r
        turn_b = ((_dots(rho_left, velocity_rows(metric, lo_r)) <= 0.0)
                  | (_dots(rho_left, velocity_rows(metric, nx_r)) <= 0.0))
        rho_right = rho_n - nx_rho + nx_r + nx_prev
        turn_c = ((_dots(rho_right, velocity_rows(metric, nx_prev)) <= 0.0)
                  | (_dots(rho_right, v_new) <= 0.0))
        turn = turn | (turn_b | turn_c).any(-1)
    return turn


def subtree_init(z0, r0, g0, joint0):
    """The state of a subtree before its first leaf."""
    c = z0.shape[0]
    return Subtree(
        n=torch.zeros(c, dtype=torch.int32, device=z0.device),
        z=z0, r=r0, g=g0,
        r_first=torch.zeros_like(r0),
        z_prop=z0,
        logp_prop=torch.zeros_like(joint0),
        g_prop=g0,
        joint_prop=joint0,
        lsw=torch.full_like(joint0, -math.inf),
        rho=torch.zeros_like(r0),
        sum_accept=torch.zeros_like(joint0),
        turning=torch.zeros(c, dtype=torch.bool, device=z0.device),
        diverging=torch.zeros(c, dtype=torch.bool, device=z0.device),
    )


def leaf_plain(vag_fn, metric, eps_signed, n, st, joint0, leaf_logu, live, ckpt, max_depth):
    """Leaf ``n`` of every chain, in PyTorch: the leapfrog step from the
    state ``st`` (a ``Subtree``) and its value-and-grad, the leaf's
    weight and take (``leaf_logu`` (C,) its log-uniforms), and the
    checkpoint write into ``ckpt`` (C, max_depth, 3, d) (even ``n``) or
    the U-turn checks (odd ``n``). Chains outside ``live`` keep ``st``.
    Returns the new ``Subtree``."""
    z, r, logp, g = leapfrog(vag_fn, st.z, st.r, st.g, eps_signed, metric)
    joint = logp - kinetic_energy(metric, r)
    delta = joint - joint0
    # NaN-safe: a non-finite delta counts as divergent
    div_leaf = ~(delta >= -DIVERGENCE_THRESHOLD)
    lw = torch.where(div_leaf, torch.full_like(joint0, -math.inf), delta)  # uncapped weight
    accept = torch.where(div_leaf, torch.zeros_like(joint0),
                         torch.exp(torch.clamp_max(delta, 0.0)))
    rho = st.rho + torch.where(div_leaf[:, None], torch.zeros_like(r), r)
    r_first = r if n == 0 else st.r_first

    new_lsw = torch.logaddexp(st.lsw, lw)
    # the ~div_leaf guard keeps a (-inf) - (-inf) NaN out of the test
    take = live & ~div_leaf & (leaf_logu < lw - new_lsw)

    if n % 2 == 0:
        slot = min(_popcount(n), max_depth - 1)
        rows = torch.stack([r, rho, st.r], dim=1)
        ckpt[:, slot] = keep(live, rows, ckpt[:, slot])
        turning = torch.zeros_like(st.turning)
    else:
        turning = ~div_leaf & iterative_uturn_check(metric, r, rho, ckpt, *checked_slots(n))

    return Subtree(
        n=st.n + live.to(torch.int32),
        z=keep(live, z, st.z),
        r=keep(live, r, st.r),
        g=keep(live, g, st.g),
        r_first=keep(live, r_first, st.r_first),
        z_prop=keep(take, z, st.z_prop),
        logp_prop=keep(take, logp, st.logp_prop),
        g_prop=keep(take, g, st.g_prop),
        joint_prop=keep(take, joint, st.joint_prop),
        lsw=keep(live, new_lsw, st.lsw),
        rho=keep(live, rho, st.rho),
        sum_accept=keep(live, st.sum_accept + accept, st.sum_accept),
        turning=keep(live, turning, st.turning),
        diverging=keep(live, div_leaf, st.diverging),
    )


def uses_kernel(z, metric):
    """Whether a subtree of positions ``z`` under ``metric`` takes the
    kernel: CUDA tensors and a diagonal metric."""
    return z.device.type == "cuda" and not metric.dense


class _Buffers(ctypes.Structure):
    """``csrc/nuts_leaf.cu``'s ``LeafBuffers``."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "vec", "scal", "n", "mask", "ckpt", "any_live", "eps", "inv", "joint0", "active",
        "leaf_logu")]
        + [(name, ctypes.c_int64) for name in ("inv_stride", "logu_stride_c",
                                                "logu_stride_n")]
        + [(name, ctypes.c_int32) for name in ("C", "d", "max_depth", "dtype")]
        + [("threshold", ctypes.c_double)])


@functools.cache
def _library():
    """The kernel's ctypes library, built at first use and bound once."""
    lib = _build.load("nuts_leaf")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nuts_leaf_start.argtypes = [ctypes.POINTER(_Buffers), ptr, ptr, ptr, ptr]
    lib.nuts_leaf_step.argtypes = [ctypes.POINTER(_Buffers), ptr, ptr] + [i32] * 5 + [ptr]
    lib.nuts_leaf_start.restype = lib.nuts_leaf_step.restype = i32
    lib.nuts_leaf_error_string.argtypes = [i32]
    lib.nuts_leaf_error_string.restype = ctypes.c_char_p
    return lib


_DTYPES = {torch.float32: 0, torch.float64: 1}
# the (C, d) fields of ``Subtree`` in the kernel's ``vec`` rows, then its
# own two: the next leaf's half-kicked momentum and drifted position
_VEC = ("z", "r", "g", "r_first", "z_prop", "g_prop", "rho")
_SCAL = ("logp_prop", "joint_prop", "lsw", "sum_accept")


class LeafKernel:
    """One subtree's state in device buffers, which ``step`` updates in
    place with one kernel launch a leaf.

    Made from the subtree's start (z0, r0, g0) (C, d), its signed step
    sizes ``eps_signed`` (C, 1), the trajectory's initial ``joint0``
    (C,), the leaves' log-uniforms ``leaf_logu`` (C, 2^depth), the
    chains that build it (``active``, (C,) bool) and the checkpoint
    stack's depth; one launch sets the state and leaf 0's drift. Then
    for each leaf n: the value-and-grad at ``z_in``, ``step(n, logp,
    g)``, and, before the next leaf, ``live_flag(n)``. The tensors must
    share one CUDA device and a float32 or float64 dtype; the inverse
    mass is (C, d) or (d,). A run's ``HostSyncs.leaf_kernel`` counts its
    leaves (``nuts/tree.py``)."""

    def __init__(self, metric, eps_signed, z0, r0, g0, joint0, leaf_logu, active, max_depth):
        if metric.dense:
            raise ValueError("the leaf kernel takes a diagonal metric")
        dtype, dev = z0.dtype, z0.device
        if dev.type != "cuda":
            raise ValueError(f"the leaf kernel takes CUDA tensors, got {dev}")
        if dtype not in _DTYPES:
            raise TypeError(f"the leaf kernel takes float32 or float64, got {dtype}")
        c, d = z0.shape
        inv = metric.inv
        named = {"r0": r0, "g0": g0, "eps_signed": eps_signed, "joint0": joint0,
                 "leaf_logu": leaf_logu, "metric.inv": inv}
        for name, t in named.items():
            if t.dtype != dtype or t.device != dev:
                raise TypeError(f"{name} is {t.dtype} on {t.device}, z0 {dtype} on {dev}")
        if (r0.shape != (c, d) or g0.shape != (c, d) or eps_signed.numel() != c
                or joint0.shape != (c,) or active.shape != (c,) or leaf_logu.shape[0] != c
                or inv.shape not in ((c, d), (d,))):
            raise ValueError("shapes do not match z0 (C, d) = "
                             f"{(c, d)}: {[tuple(t.shape) for t in named.values()]}")
        if active.dtype != torch.bool or active.device != dev:
            raise TypeError(f"active must be bool on {dev}")
        if inv.stride(-1) != 1:
            inv = inv.contiguous()
        self._eps = eps_signed.reshape(c).contiguous()
        self._joint0, self._active, self._inv = joint0.contiguous(), active.contiguous(), inv
        self._leaf_logu = leaf_logu
        self.max_depth = max_depth
        vec = torch.empty(len(_VEC) + 2, c, d, dtype=dtype, device=dev)
        scal = torch.empty(len(_SCAL), c, dtype=dtype, device=dev)
        self._n = torch.empty(c, dtype=torch.int32, device=dev)
        self._mask = torch.empty(3, c, dtype=torch.bool, device=dev)
        #: the checkpoint stack (C, max_depth, 3, d) and the live chains (C,)
        self.ckpt = torch.zeros(c, max_depth, 3, d, dtype=dtype, device=dev)
        self.live = self._mask[2]
        self._any_live = torch.empty(2, dtype=torch.int32, device=dev)
        self._flags = (self._any_live[0], self._any_live[1])
        self._vec, self._scal = vec, scal
        #: the next leaf's position, where the value-and-grad is taken
        self.z_in = vec[len(_VEC) + 1]
        self._buf = _Buffers(
            vec.data_ptr(), scal.data_ptr(), self._n.data_ptr(), self._mask.data_ptr(),
            self.ckpt.data_ptr(), self._any_live.data_ptr(), self._eps.data_ptr(),
            inv.data_ptr(), self._joint0.data_ptr(), self._active.data_ptr(),
            leaf_logu.data_ptr(), inv.stride(0) if inv.ndim == 2 else 0,
            leaf_logu.stride(0), leaf_logu.stride(1), c, d, max_depth, _DTYPES[dtype],
            DIVERGENCE_THRESHOLD)
        self._ref = ctypes.byref(self._buf)
        self._lib = _library()
        self._stream = torch.cuda.current_stream(dev).cuda_stream
        self._dtype, self._c, self._d, self._device = dtype, c, d, dev
        z0, r0, g0 = (t.contiguous() for t in (z0, r0, g0))
        self._launch(self._lib.nuts_leaf_start, self._ref, z0.data_ptr(), r0.data_ptr(),
                     g0.data_ptr(), self._stream)

    def _launch(self, fn, *args):
        # a launch goes to the calling thread's current device
        if torch.cuda.current_device() == self._device.index:
            rc = fn(*args)
        else:
            with torch.cuda.device(self._device):
                rc = fn(*args)
        if rc != 0:
            raise RuntimeError("nuts_leaf kernel launch failed: "
                               + self._lib.nuts_leaf_error_string(rc).decode())

    def step(self, n, logp, g, has_next):
        """Leaf ``n`` from the value-and-grad (``logp`` (C,), ``g`` (C, d))
        at ``z_in``; with ``has_next`` it also leaves the next leaf's
        position in ``z_in``."""
        if (logp.dtype != self._dtype or g.dtype != self._dtype or logp.shape != (self._c,)
                or g.shape != (self._c, self._d)):
            raise TypeError(f"value-and-grad gave {logp.dtype} {tuple(logp.shape)} and "
                            f"{g.dtype} {tuple(g.shape)}, expected {self._dtype} "
                            f"({self._c},) and ({self._c}, {self._d})")
        if not 0 <= n < self._leaf_logu.shape[1]:
            raise IndexError(f"leaf {n} of a subtree of {self._leaf_logu.shape[1]} leaves")
        logp, g = logp.contiguous(), g.contiguous()
        if n % 2 == 0:
            slot, (idx_min, idx_max) = min(_popcount(n), self.max_depth - 1), (0, -1)
        else:
            slot, (idx_min, idx_max) = 0, checked_slots(n)
        self._launch(self._lib.nuts_leaf_step, self._ref, logp.data_ptr(), g.data_ptr(), n, slot,
                     idx_min, idx_max, int(has_next), self._stream)

    def live_flag(self, n):
        """A one-element device tensor, nonzero if some chain is live after
        leaf ``n``."""
        return self._flags[n & 1]

    def subtree(self):
        """The state as a ``Subtree`` of views of the buffers."""
        fields = dict(zip(_VEC, self._vec), **dict(zip(_SCAL, self._scal)))
        return Subtree(n=self._n, turning=self._mask[0], diverging=self._mask[1], **fields)
