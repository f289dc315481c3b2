"""Constraint transforms: unconstrained z -> constrained x, with log|det J|
(``exmc_tpu/transforms.py``).

Inputs carry a leading chain axis: z is (C, *ushape), and
``log_abs_det_jacobian`` sums over the event axes only, giving (C,).
Shape-changing transforms (stick_breaking and zero_sum: K-1 -> K;
cholesky_corr: d(d-1)/2 -> (d, d)) act on the trailing event axes,
never on the chain axis. The exp-based transforms clamp z at +/-20 in
f32, as the JAX package does, with the same gradient at the clamp edge.
"""

from functools import lru_cache

import math

import numpy as np
import torch

from exmc_tpu_torch import math as xm
from exmc_tpu_torch.config import log_transform_clamp


def _clip(z, lim):
    """clip(z, -lim, lim) as max/min: at z == +/-lim the gradient is 0.5,
    as JAX's ``jnp.clip`` gives (``torch.clamp`` would give 1)."""
    return torch.minimum(torch.maximum(z, z.new_full((), -lim)),
                         z.new_full((), lim))


def _sigmoid(z):
    """1 / (1 + exp(-z)), the JAX package's formula."""
    return torch.reciprocal(1.0 + torch.exp(-z))


def _cumprod(s):
    """Cumulative product along the last axis as a chain of multiplies:
    the backward of ``torch.cumprod`` tests its input for zeros on the
    host, which a CUDA graph cannot capture."""
    out = [s[..., 0]]
    for j in range(1, s.shape[-1]):
        out.append(out[-1] * s[..., j])
    return torch.stack(out, dim=-1)


def _exclusive(c, fill):
    """Shift a cumulative op along the last axis by one: [fill, c_0, ...,
    c_{K-2}]."""
    return torch.cat([torch.full_like(c[..., :1], fill), c[..., :-1]], dim=-1)


_DEVICE_CONSTS = {}


def _device_const(key, like, make, cast=False):
    """A constant tensor per (key, dtype, device), made once from the
    numpy array ``make()`` (cast to ``like``'s dtype if ``cast``): its
    host -> device copy then happens at the first (eager) call, never
    inside a CUDA graph capture."""
    k = (key, like.dtype, like.device)
    if k not in _DEVICE_CONSTS:
        _DEVICE_CONSTS[k] = torch.as_tensor(
            make(), dtype=like.dtype if cast else None, device=like.device)
    return _DEVICE_CONSTS[k]


@lru_cache(maxsize=None)
def _tril_indices(d):
    """Strict-lower-triangle (row, col) indices, row-major: the packing
    order of the cholesky_corr unconstrained vector."""
    return np.tril_indices(d, -1)


@lru_cache(maxsize=None)
def _zero_sum_basis(k):
    """Orthonormal basis (k, k-1) of {x : sum x = 0}, float64 numpy (the
    same QR as the JAX package's)."""
    a = np.eye(k, k - 1)
    a[-1, :] = -1.0
    q, _ = np.linalg.qr(a)
    return q


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

    def constrained_shape(self, shape):
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


class LogitTransform(Transform):
    """x = sigmoid(z); log|J| = -softplus(z) - softplus(-z)."""

    name = "logit"

    def forward(self, z):
        return _sigmoid(z)

    def inverse(self, x):
        return xm.logit(x)

    def log_abs_det_jacobian(self, z):
        return xm.event_sum(-xm.softplus(z) - xm.softplus(-z))


class StickBreakingTransform(Transform):
    """z (..., K-1) -> x (..., K) on the simplex:
    y_i = sigmoid(z_i); x_i = y_i prod_{j<i}(1 - y_j); x_K = prod(1 - y).
    log|J| = sum_i [log y_i + log(1 - y_i) + log prod_{j<i}(1 - y_j)]."""

    name = "stick_breaking"

    @staticmethod
    def _parts(z):
        log_y = -xm.softplus(-z)
        log_1my = -xm.softplus(z)
        csum = torch.cumsum(log_1my, dim=-1)
        return log_y, log_1my, csum, _exclusive(csum, 0.0)

    def forward(self, z):
        log_y, _, csum, log_rem = self._parts(z)
        return torch.cat([torch.exp(log_y + log_rem), torch.exp(csum[..., -1:])],
                         dim=-1)

    def inverse(self, x):
        x_head = x[..., :-1]
        rem = 1.0 - _exclusive(torch.cumsum(x_head, dim=-1), 0.0)
        return torch.log(x_head) - torch.log(rem - x_head)

    def log_abs_det_jacobian(self, z):
        log_y, log_1my, _, log_rem = self._parts(z)
        return xm.event_sum(log_y + log_1my + log_rem)

    def unconstrained_shape(self, shape):
        if len(shape) == 0:
            raise ValueError("stick_breaking requires a vector-shaped RV")
        return tuple(shape[:-1]) + (shape[-1] - 1,)

    def constrained_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] + 1,)


class OrderedTransform(Transform):
    """z (..., K) -> strictly increasing x: x_1 = z_1,
    x_k = x_{k-1} + exp(z_k); log|J| = sum_{k>=2} z_k."""

    name = "ordered"

    def forward(self, z):
        lim = log_transform_clamp()
        steps = torch.exp(_clip(z[..., 1:], lim))
        return torch.cat([z[..., :1], z[..., :1] + torch.cumsum(steps, dim=-1)],
                         dim=-1)

    def inverse(self, x):
        return torch.cat([x[..., :1], torch.log(torch.diff(x, dim=-1))], dim=-1)

    def log_abs_det_jacobian(self, z):
        lim = log_transform_clamp()
        return xm.event_sum(_clip(z[..., 1:], lim))


class ZeroSumTransform(Transform):
    """z (..., K-1) -> x (..., K) with sum(x) = 0: the isometric embedding
    onto the complement of the ones vector, so log|det J| = 0."""

    name = "zero_sum"

    @staticmethod
    def _basis(k, like):
        return _device_const(("zero_sum", int(k)), like,
                             lambda: _zero_sum_basis(int(k)), cast=True)

    def forward(self, z):
        return z @ self._basis(z.shape[-1] + 1, z).T

    def inverse(self, x):
        return x @ self._basis(x.shape[-1], x)

    def unconstrained_shape(self, shape):
        if len(shape) == 0:
            raise ValueError("zero_sum requires a vector-shaped RV")
        return tuple(shape[:-1]) + (shape[-1] - 1,)

    def constrained_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] + 1,)


class PositiveOrderedTransform(Transform):
    """z (..., K) -> strictly increasing positive x:
    x_k = sum_{j<=k} exp(z_j); log|J| = sum z."""

    name = "positive_ordered"

    def forward(self, z):
        lim = log_transform_clamp()
        return torch.cumsum(torch.exp(_clip(z, lim)), dim=-1)

    def inverse(self, x):
        return torch.cat([torch.log(x[..., :1]), torch.log(torch.diff(x, dim=-1))],
                         dim=-1)

    def log_abs_det_jacobian(self, z):
        lim = log_transform_clamp()
        return xm.event_sum(_clip(z, lim))


class CholeskyCorrTransform(Transform):
    """z (..., d(d-1)/2) -> L (..., d, d), the Cholesky factor of a
    correlation matrix (Stan's canonical partial correlations):
    x = tanh(z) row-major over the strict lower triangle,
    L[i,j] = x_ij sqrt(1 - sum_{k<j} L[i,k]^2), L[i,i] = sqrt(rem_ii);
    log|J| = sum [log(1 - x_ij^2) + 0.5 log rem_ij]."""

    name = "cholesky_corr"

    @staticmethod
    def _dim(m):
        d = int(round((1.0 + (1.0 + 8.0 * m) ** 0.5) / 2.0))
        if d * (d - 1) // 2 != m:
            raise ValueError(f"invalid cholesky_corr length {m}")
        return d

    @staticmethod
    def _strict(d, like):
        return _device_const(("strict", d), like,
                             lambda: np.tri(d, d, -1, dtype=bool))

    @staticmethod
    def _tril(d, like):
        """Device (rows, cols) of the strict lower triangle."""
        return (_device_const(("tril_rows", d), like, lambda: _tril_indices(d)[0]),
                _device_const(("tril_cols", d), like, lambda: _tril_indices(d)[1]))

    @classmethod
    def _scatter_tril(cls, v, d):
        """The packed row-major vector (..., m) into the strict lower
        triangle of a (..., d, d) matrix, by one scatter."""
        rows, cols = cls._tril(d, v)
        lead, m = v.shape[:-1], v.shape[-1]
        flat = v.reshape(-1, m)
        idx = (rows * d + cols).expand(flat.shape[0], m)
        out = flat.new_zeros(flat.shape[0], d * d).scatter(1, idx, flat)
        return out.reshape(lead + (d, d))

    @staticmethod
    def _rem(x):
        """rem[i, j] = prod_{k<j} (1 - x[i,k]^2): an exclusive cumprod
        along each row; rem[i, i] is the full row product."""
        return _exclusive(_cumprod(1.0 - x * x), 1.0)

    def forward(self, z):
        d = self._dim(z.shape[-1])
        x = self._scatter_tril(torch.tanh(z), d)
        rem = self._rem(x)
        low = torch.where(self._strict(d, z), x * torch.sqrt(rem),
                          torch.zeros_like(x))
        return low + torch.diag_embed(torch.sqrt(torch.diagonal(rem, dim1=-2, dim2=-1)))

    def inverse(self, L):
        d = L.shape[-1]
        rows, cols = _tril_indices(d)
        low = torch.where(self._strict(d, L), L, torch.zeros_like(L))
        rem = 1.0 - _exclusive(torch.cumsum(low * low, dim=-1), 0.0)
        x = low / torch.sqrt(torch.clamp_min(rem, 1e-30))
        z = torch.atanh(torch.clamp(x, -1.0 + 1e-7, 1.0 - 1e-7))
        return z[..., rows, cols]

    def log_abs_det_jacobian(self, z):
        d = self._dim(z.shape[-1])
        # log(1 - tanh^2 z), overflow-safe
        log_dtanh = 2.0 * (math.log(2.0) - z - xm.softplus(-2.0 * z))
        rem = self._rem(self._scatter_tril(torch.tanh(z), d))
        rows, cols = self._tril(d, z)
        return xm.event_sum(log_dtanh) + 0.5 * xm.event_sum(
            torch.log(torch.clamp_min(rem[..., rows, cols], 1e-30)))

    def unconstrained_shape(self, shape):
        if len(shape) < 2 or shape[-1] != shape[-2]:
            raise ValueError("cholesky_corr requires a (d, d)-shaped RV")
        d = shape[-1]
        return tuple(shape[:-2]) + (d * (d - 1) // 2,)

    def constrained_shape(self, shape):
        d = self._dim(shape[-1])
        return tuple(shape[:-1]) + (d, d)


class IntervalTransform(Transform):
    """x = lower + (upper - lower) sigmoid(z), for constant bounds."""

    name = "interval"

    def __init__(self, lower, upper):
        self.lower = lower
        self.upper = upper

    def forward(self, z):
        return self.lower + (self.upper - self.lower) * _sigmoid(z)

    def inverse(self, x):
        return xm.logit((x - self.lower) / (self.upper - self.lower))

    def log_abs_det_jacobian(self, z):
        log_width = math.log(self.upper - self.lower)
        return xm.event_sum(log_width - xm.softplus(z) - xm.softplus(-z))


class LowerBoundTransform(Transform):
    """x = lower + exp(z), z clamped to +/-20."""

    name = "lower_bound"

    def __init__(self, lower):
        self.lower = lower

    def forward(self, z):
        return self.lower + torch.exp(_clip(z, log_transform_clamp()))

    def inverse(self, x):
        return torch.log(x - self.lower)

    def log_abs_det_jacobian(self, z):
        return xm.event_sum(_clip(z, log_transform_clamp()))


class UpperBoundTransform(Transform):
    """x = upper - exp(z), z clamped to +/-20."""

    name = "upper_bound"

    def __init__(self, upper):
        self.upper = upper

    def forward(self, z):
        return self.upper - torch.exp(_clip(z, log_transform_clamp()))

    def inverse(self, x):
        return torch.log(self.upper - x)

    def log_abs_det_jacobian(self, z):
        return xm.event_sum(_clip(z, log_transform_clamp()))


IDENTITY = Transform()
LOG = LogTransform()
SOFTPLUS = SoftplusTransform()
LOGIT = LogitTransform()
STICK_BREAKING = StickBreakingTransform()
CHOLESKY_CORR = CholeskyCorrTransform()
ORDERED = OrderedTransform()
POSITIVE_ORDERED = PositiveOrderedTransform()
ZERO_SUM = ZeroSumTransform()

_REGISTRY = {
    None: IDENTITY,
    "identity": IDENTITY,
    "log": LOG,
    "softplus": SOFTPLUS,
    "logit": LOGIT,
    "stick_breaking": STICK_BREAKING,
    "cholesky_corr": CHOLESKY_CORR,
    "ordered": ORDERED,
    "positive_ordered": POSITIVE_ORDERED,
    "zero_sum": ZERO_SUM,
}

# The bounded transforms carry their bounds and are built per RV.
BOUNDED = {"interval": IntervalTransform, "lower_bound": LowerBoundTransform,
           "upper_bound": UpperBoundTransform}


def get(name):
    """Resolve a transform by name, a bounded one by ``(name, *bounds)``
    (e.g. ``("interval", 2.0, 5.0)``), or pass a Transform instance
    through."""
    if isinstance(name, Transform):
        return name
    if isinstance(name, tuple) and name and name[0] in BOUNDED:
        return BOUNDED[name[0]](*name[1:])
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown transform: {name!r}") from None


def unconstrained_shape(transform, shape):
    return get(transform).unconstrained_shape(tuple(shape))
