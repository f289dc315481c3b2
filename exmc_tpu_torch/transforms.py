"""Constraint transforms: unconstrained z -> constrained x, with log|det J|
(``exmc_tpu/transforms.py:47-96,399-431``).

Inputs carry a leading chain axis: z is (C, *ushape), and
``log_abs_det_jacobian`` sums over the event axes only, giving (C,).
The log transform clamps z at +/-20 in f32, as the JAX package does,
with the same gradient at the clamp edge.
"""

import torch

from exmc_tpu_torch import math as xm
from exmc_tpu_torch.config import log_transform_clamp


def _clip(z, lim):
    """clip(z, -lim, lim) as max/min: at z == +/-lim the gradient is 0.5,
    as JAX's ``jnp.clip`` gives (``torch.clamp`` would give 1)."""
    return torch.minimum(torch.maximum(z, z.new_full((), -lim)),
                         z.new_full((), lim))


class Transform:
    name = "identity"

    def forward(self, z):
        return z

    def inverse(self, x):
        return x

    def log_abs_det_jacobian(self, z):
        return z.new_zeros(z.shape[:1])

    def unconstrained_shape(self, shape):
        return shape


class LogTransform(Transform):
    """x = exp(z), with z clamped to +/-20."""

    name = "log"

    def forward(self, z):
        lim = log_transform_clamp()
        return torch.exp(_clip(z, lim))

    def inverse(self, x):
        return torch.log(x)

    def log_abs_det_jacobian(self, z):
        lim = log_transform_clamp()
        return xm.event_sum(_clip(z, lim))


class SoftplusTransform(Transform):
    """x = softplus(z); log|J| = log sigmoid(z) = -softplus(-z)."""

    name = "softplus"

    def forward(self, z):
        return xm.softplus(z)

    def inverse(self, x):
        return xm.inv_softplus(x)

    def log_abs_det_jacobian(self, z):
        return xm.event_sum(-xm.softplus(-z))


IDENTITY = Transform()
LOG = LogTransform()
SOFTPLUS = SoftplusTransform()

_REGISTRY = {
    None: IDENTITY,
    "identity": IDENTITY,
    "log": LOG,
    "softplus": SOFTPLUS,
}

# Transforms of the JAX package that the port has not taken over yet.
_NOT_PORTED = ("logit", "stick_breaking", "cholesky_corr", "ordered",
               "positive_ordered", "zero_sum", "interval", "lower_bound",
               "upper_bound")


def get(name):
    """Resolve a transform by name (or pass a Transform instance through)."""
    if isinstance(name, Transform):
        return name
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"transform {name!r} is not ported yet (ROADMAP §1 item 2)")
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown transform: {name!r}") from None
