"""LDL' factorisation and solve of batched symmetric tridiagonal systems
with a constant off-diagonal, one launch each, as a hand-written CUDA
kernel (``csrc/tridiag.cu``), in float64: the two recurrences of every
Newton step of the Laplace marginal, whose plain form
(``marginal._thomas_factor`` and ``_thomas_solve``) is a log-depth
doubling scan of a few hundred small kernels.

The kernel has no backward. ``marginal`` sends it the calls that need
none (``usable``): CUDA float64 tensors, outside autograd and outside
``torch.func`` transforms; every other call keeps the plain form.
"""

import ctypes

import torch

from exmc_tpu_torch import _build


def _bind(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tri_factor.argtypes = [ptr, ptr, i32, i32, ptr, ptr, ptr]
    lib.tri_solve.argtypes = [ptr, ptr, ptr, i32, i32, ptr, ptr]
    lib.tri_factor.restype = lib.tri_solve.restype = i32
    lib.tri_error_string.argtypes = [i32]
    lib.tri_error_string.restype = ctypes.c_char_p
    return lib


def usable(*tensors):
    """Whether a call on ``tensors`` may take the kernel: all on one CUDA
    device, float64, with a time axis of at least 2, none needing a
    gradient, and no ``torch.func`` transform active (the kernel reads
    the tensors' memory, which a transform's wrappers do not expose)."""
    first = tensors[0]
    if first.device.type != "cuda" or first.shape[-1] < 2:
        return False
    if any(x.dtype != torch.float64 or x.device != first.device for x in tensors):
        return False
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        return False
    return torch._C._functorch.peek_interpreter_stack() is None


def _rows(x, batch, width):
    return x.expand(*batch, width).reshape(-1, width).contiguous()


def _launch(name, *args):
    lib = _bind(_build.load("tridiag"))
    rc = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: " + lib.tri_error_string(rc).decode())


def tri_factor(a, b):
    """(delta (..., T), ell (..., T-1)) of the LDL' factor of the
    tridiagonal with diagonal ``a`` (..., T) and off-diagonal ``b``
    (..., 1), as ``marginal._thomas_factor`` returns them."""
    t = a.shape[-1]
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    a2, b2 = _rows(a, batch, t), _rows(b, batch, 1)
    p = a2.shape[0]
    delta = torch.empty_like(a2)
    ell = torch.empty(p, t - 1, dtype=a2.dtype, device=a2.device)
    if p:
        with torch.cuda.device(a2.device):
            _launch("tri_factor", a2.data_ptr(), b2.data_ptr(), p, t, delta.data_ptr(),
                    ell.data_ptr())
    return delta.reshape(*batch, t), ell.reshape(*batch, t - 1)


def tri_solve(delta, ell, rhs):
    """x of (L D L') x = ``rhs`` (..., T) for the factor (``delta``,
    ``ell``) of ``tri_factor``, as ``marginal._thomas_solve`` returns
    it."""
    t = rhs.shape[-1]
    batch = torch.broadcast_shapes(delta.shape[:-1], ell.shape[:-1], rhs.shape[:-1])
    d2, l2, r2 = _rows(delta, batch, t), _rows(ell, batch, t - 1), _rows(rhs, batch, t)
    p = d2.shape[0]
    x = torch.empty_like(r2)
    if p:
        with torch.cuda.device(r2.device):
            _launch("tri_solve", d2.data_ptr(), l2.data_ptr(), r2.data_ptr(), p, t,
                    x.data_ptr())
    return x.reshape(*batch, t)
