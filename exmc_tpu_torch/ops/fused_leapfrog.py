"""Fused K-step leapfrog for diagonal-Gaussian potentials
(``exmc_tpu/ops/fused_leapfrog.py``), as a hand-written CUDA kernel.

logp(q) = -0.5 sum(prec * (q - mu)^2), grad = -prec * (q - mu), with a
diagonal inverse mass, for every chain of a (C, d) batch. The kernel
(``csrc/fused_leapfrog.cu``) keeps the whole K-step loop in registers.

As in the JAX package, no sampler path dispatches to it: it is a public
op, ``exmc_tpu_torch.ops.fused_leapfrog_gaussian``. A CPU tensor goes to
the plain PyTorch version; a CUDA tensor goes to the kernel, or the
wrapper raises.
"""

import ctypes

import torch

from exmc_tpu_torch import _build


def reference_leapfrog_gaussian(q, p, mu, prec, inv_mass, eps, num_steps):
    """Plain PyTorch version: a loop over the K steps, the JAX
    ``reference_leapfrog_gaussian``'s arithmetic in its order."""

    def grad(qq):
        return -prec * (qq - mu)

    for _ in range(num_steps):
        p_half = p + 0.5 * eps * grad(q)
        q = q + eps * inv_mass * p_half
        p = p_half + 0.5 * eps * grad(q)
    diff = q - mu
    logp = -0.5 * torch.sum(prec * diff * diff, dim=-1)
    return q, p, logp


def _bind(lib):
    fn = lib.fused_leapfrog_gaussian_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_float] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    lib.fused_leapfrog_error_string.argtypes = [ctypes.c_int]
    lib.fused_leapfrog_error_string.restype = ctypes.c_char_p
    lib.fused_leapfrog_max_d.argtypes = []
    lib.fused_leapfrog_max_d.restype = ctypes.c_int
    return lib


def _check(q, p, mu, prec, inv_mass):
    if q.ndim != 2 or p.shape != q.shape:
        raise ValueError(f"q and p must be (C, d) of one shape, got "
                         f"{tuple(q.shape)} and {tuple(p.shape)}")
    d = q.shape[1]
    for name, t in (("mu", mu), ("prec", prec), ("inv_mass", inv_mass)):
        if t.shape != (d,):
            raise ValueError(f"{name} must be ({d},), got {tuple(t.shape)}")
    for name, t in (("q", q), ("p", p), ("mu", mu), ("prec", prec),
                    ("inv_mass", inv_mass)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_leapfrog_gaussian(q, p, mu, prec, inv_mass, eps, num_steps):
    """Run ``num_steps`` leapfrog steps for all chains.

    q, p: (C, d) float32, contiguous; mu, prec, inv_mass: (d,); eps: a
    Python float; num_steps: a non-negative int. On CUDA tensors this
    launches the kernel on the current stream; on CPU tensors it runs
    the plain version. Returns (q_final (C, d), p_final (C, d),
    logp_final (C,))."""
    _check(q, p, mu, prec, inv_mass)
    eps = float(eps)
    num_steps = int(num_steps)
    if num_steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {num_steps}")
    if q.device.type == "cpu":
        return reference_leapfrog_gaussian(q, p, mu, prec, inv_mass, eps,
                                           num_steps)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    lib = _bind(_build.load("fused_leapfrog"))
    c, d = q.shape
    if d > lib.fused_leapfrog_max_d():
        raise ValueError(f"d={d} exceeds the kernel's {lib.fused_leapfrog_max_d()}")
    q_out = torch.empty_like(q)
    p_out = torch.empty_like(p)
    logp_out = torch.empty(c, dtype=q.dtype, device=q.device)
    if c == 0:
        return q_out, p_out, logp_out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fused_leapfrog_gaussian_f32(
            q.data_ptr(), p.data_ptr(), mu.data_ptr(), prec.data_ptr(),
            inv_mass.data_ptr(), eps, c, d, num_steps, q_out.data_ptr(),
            p_out.data_ptr(), logp_out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("fused_leapfrog kernel launch failed: "
                           + lib.fused_leapfrog_error_string(rc).decode())
    fused_leapfrog_gaussian.launches += 1
    return q_out, p_out, logp_out


# kernel launches since the count was last set to 0
fused_leapfrog_gaussian.launches = 0
