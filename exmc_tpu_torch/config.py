"""Numeric and device settings of the PyTorch port.

The port runs in float32, like the JAX package with x64 off
(``exmc_tpu/config.py:184-202``), unless float64 is switched on: for
the process by ``EXMC_TPU_TORCH_X64=1`` (read once, at import), or for
a block by ``with config.x64():``, so one process can run both. Under
float64 every flat vector, compiled log-density, sampler state and
constant is float64 and the exp/log clamp widens to 200, as under the
JAX package's ``EXMC_TPU_X64=1``. Entry points take an explicit
``device`` that defaults to ``"cuda"``; the CPU is used only when the
caller asks for it. The XLA executable caches of the JAX package
(``aot.py``, ``compilation_cache_dir`` and the other cache helpers) have
no counterpart: the port compiles no executable ahead of time, and
``EXMC_AOT_CACHE`` has no effect on it (ROADMAP §3).
"""

import contextlib
import os

import numpy as np
import torch

_x64 = os.environ.get("EXMC_TPU_TORCH_X64", "0") == "1"

# Scale parameters are floored at this value so that badly-scaled warmup
# points never divide by zero.
SCALE_FLOOR = 1e-30

# Divergence threshold on the joint-logp drop at a tree leaf: a leaf
# diverges iff delta_joint < -1000 or is not finite.
DIVERGENCE_THRESHOLD = 1000.0


def x64_enabled() -> bool:
    return _x64


@contextlib.contextmanager
def x64(enabled=True):
    """Run the block in float64 (``enabled=False``: in float32); the
    previous setting comes back on exit. Models compiled and samplers
    built inside the block keep its dtype."""
    global _x64
    prev, _x64 = _x64, bool(enabled)
    try:
        yield
    finally:
        _x64 = prev


def default_dtype():
    """Floating dtype of flat vectors and compiled log-densities."""
    return torch.float64 if _x64 else torch.float32


def np_dtype():
    """``default_dtype()`` as a numpy dtype."""
    return np.float64 if _x64 else np.float32


def log_transform_clamp():
    """Clamp of the exp/log constraint transform: exp(20) ~ 4.9e8 stays
    finite in f32; f64 allows a much wider range."""
    return 200.0 if _x64 else 20.0


def default_device():
    return "cuda"


def prepare_device(device=None) -> torch.device:
    """Resolve ``device`` (default ``"cuda"``) for an entry point.

    Asking for CUDA without a card raises: there is no fallback to the
    CPU. Also turns TF32 off for matrix products and cuDNN, so every
    float32 operation on the card runs in full float32, as the JAX
    reference does on the CPU."""
    dev = torch.device(default_device() if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def backend_info(device=None):
    """Runtime backend report with the JAX package's keys
    (``exmc_tpu/config.py:205``), filled with torch's values for
    ``device`` (default ``"cuda"``): ``platform`` is ``"gpu"`` on a card
    and ``"cpu"`` otherwise, and ``devices`` names each visible card."""
    dev = prepare_device(device)
    if dev.type == "cuda":
        devices = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        platform = "gpu"
    else:
        devices, platform = ["cpu"], "cpu"
    return {
        "platform": platform,
        "num_devices": len(devices),
        "devices": devices,
        "x64": x64_enabled(),
        "default_dtype": str(default_dtype()).removeprefix("torch."),
    }
