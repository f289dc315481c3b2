"""The summed Bernoulli-logit GLM likelihood and its gradient in one pass
over the design matrix, as a hand-written CUDA kernel
(``csrc/glm_logit.cu``).

For chains c, rows i and columns j: eta_ci = x_i . beta_c + b0_c;
lp_c = sum_i [y_i eta_ci - softplus(eta_ci)]; d lp_c / d beta_c =
sum_i r_ci x_i and d lp_c / d b0_c = sum_i r_ci, with r_ci = y_i -
sigmoid(eta_ci). The kernel keeps the (C, N) logits and residuals out of
device memory. It replaces no TPU kernel: the JAX package leaves this
likelihood to XLA.

The compiler's value-and-grad dispatches a model's observation to it
(``compiler.glm_logit_terms``). A CPU tensor goes to the plain PyTorch
version; a CUDA tensor goes to the kernel, or the wrapper raises.
"""

import ctypes

import torch
from torch.autograd.function import once_differentiable

from exmc_tpu_torch import _build


def glm_logit_plain(x, y, beta, b0=None):
    """Plain PyTorch version: the compiled model's arithmetic for the
    logits and the likelihood (``Bernoulli.logpdf`` of logits), and the
    gradient that autograd of it gives, r = y - sigmoid(eta) against x.
    Returns (lp (C,), grad beta (C, D), grad b0 (C,))."""
    eta = beta @ x.T
    if b0 is not None:
        eta = eta + b0[:, None]
    lp = torch.sum(y * eta - torch.logaddexp(torch.zeros_like(eta), eta), dim=-1)
    r = y - torch.sigmoid(eta)
    return lp, r @ x, torch.sum(r, dim=-1)


def _bind(lib):
    fn = lib.glm_logit_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    lib.glm_logit_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.glm_logit_blocks.restype = ctypes.c_int
    lib.glm_logit_max_d.argtypes = []
    lib.glm_logit_max_d.restype = ctypes.c_int
    lib.glm_logit_error_string.argtypes = [ctypes.c_int]
    lib.glm_logit_error_string.restype = ctypes.c_char_p
    return lib


def max_d():
    """The largest number of columns the kernel takes (its shared
    memory); builds the kernel at first use."""
    return _bind(_build.load("glm_logit")).glm_logit_max_d()


def _check(x, y, beta, b0):
    if x.ndim != 2 or beta.ndim != 2 or y.shape != x.shape[:1] or beta.shape[1] != x.shape[1]:
        raise ValueError(f"x (N, D), y (N,) and beta (C, D) expected, got {tuple(x.shape)}, "
                         f"{tuple(y.shape)} and {tuple(beta.shape)}")
    if b0 is not None and b0.shape != beta.shape[:1]:
        raise ValueError(f"b0 must be ({beta.shape[0]},), got {tuple(b0.shape)}")
    for name, t in (("x", x), ("y", y), ("beta", beta), ("b0", b0)):
        if t is None:
            continue
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def glm_logit_value_and_grad(x, y, beta, b0=None):
    """(lp (C,), grad beta (C, D), grad b0 (C,)) of the summed likelihood.

    x (N, D), y (N,), beta (C, D) and b0 (C,) or None (no intercept; its
    gradient is then returned all the same). On CUDA tensors, which must
    be float32 with D up to ``max_d()``, this launches the kernel on the
    current stream; on CPU tensors it runs the plain version."""
    _check(x, y, beta, b0)
    if x.device.type == "cpu":
        return glm_logit_plain(x, y, beta, b0)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32, got {x.dtype}")
    lib = _bind(_build.load("glm_logit"))
    (n, d), c = x.shape, beta.shape[0]
    if not 1 <= d <= lib.glm_logit_max_d():
        raise ValueError(f"the kernel takes 1 to {lib.glm_logit_max_d()} columns, got {d}")
    if n == 0 or c == 0:
        return x.new_zeros(c), x.new_zeros(c, d), x.new_zeros(c)
    lp = torch.empty(c, dtype=x.dtype, device=x.device)
    g_beta = torch.empty(c, d, dtype=x.dtype, device=x.device)
    g_b0 = torch.empty(c, dtype=x.dtype, device=x.device)
    x, y, beta = x.contiguous(), y.contiguous(), beta.contiguous()
    b0 = None if b0 is None else b0.contiguous()
    with torch.cuda.device(x.device):
        nblk = lib.glm_logit_blocks(n, c)
        if nblk < 0:
            raise RuntimeError("glm_logit: " + lib.glm_logit_error_string(-nblk).decode())
        partial = torch.empty(nblk, c, d + 2, dtype=x.dtype, device=x.device)
        rc = lib.glm_logit_f32(
            x.data_ptr(), y.data_ptr(), beta.data_ptr(), None if b0 is None else b0.data_ptr(),
            n, d, c, partial.data_ptr(), nblk, lp.data_ptr(), g_beta.data_ptr(),
            g_b0.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("glm_logit kernel launch failed: "
                           + lib.glm_logit_error_string(rc).decode())
    return lp, g_beta, g_b0


class _GlmLogit(torch.autograd.Function):
    """The summed likelihood, whose forward keeps the gradient the kernel
    computed and whose backward scales it by ``grad_output``. Not twice
    differentiable: a Hessian takes the model's eager ``logp``."""

    @staticmethod
    def forward(ctx, x, y, beta, b0):
        lp, g_beta, g_b0 = glm_logit_value_and_grad(x, y, beta, b0)
        ctx.save_for_backward(g_beta, g_b0)
        ctx.intercept = b0 is not None
        return lp

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_lp):
        g_beta, g_b0 = ctx.saved_tensors
        return (None, None, grad_lp[:, None] * g_beta,
                grad_lp * g_b0 if ctx.intercept else None)


def glm_logit(x, y, beta, b0=None):
    """lp (C,) of ``glm_logit_value_and_grad``, differentiable in
    ``beta`` and ``b0`` (once)."""
    return _GlmLogit.apply(x, y, beta, b0)
