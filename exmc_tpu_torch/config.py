"""Numeric and device settings of the PyTorch port.

The port runs in float32 throughout, like the JAX package with x64 off
(``exmc_tpu/config.py:184-202``). Entry points take an explicit
``device`` that defaults to ``"cuda"``; the CPU is used only when the
caller asks for it. The x64 toggle and the XLA/AOT caches of the JAX
package have no counterpart here yet (ROADMAP §1 item 14).
"""

import torch

# Scale parameters are floored at this value so that badly-scaled warmup
# points never divide by zero.
SCALE_FLOOR = 1e-30

# Divergence threshold on the joint-logp drop at a tree leaf: a leaf
# diverges iff delta_joint < -1000 or is not finite.
DIVERGENCE_THRESHOLD = 1000.0


def default_dtype():
    """Floating dtype of flat vectors and compiled log-densities."""
    return torch.float32


def log_transform_clamp():
    """Clamp of the exp/log constraint transform: exp(20) ~ 4.9e8 stays
    finite in f32."""
    return 20.0


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
