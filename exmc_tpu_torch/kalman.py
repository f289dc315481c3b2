"""Exact linear-Gaussian state-space inference, Kalman filter and RTS
smoother (``exmc_tpu/kalman.py``).

Model:  x_t = F x_{t-1} + w_t,  w ~ N(0, Q),   x_1 ~ N(mu0, P0)
        y_t = h' x_t + v_t,     v ~ N(0, r)    (scalar observations)

The JAX package's ``lax.scan`` over time is a host loop over T here:
each step is a few (m, m) products, so the filter is a readout (example
47's smoothed bands, the tests' oracle), not a sampler's log-density;
the non-Gaussian members of the family use the Laplace marginals in
``exmc_tpu_torch.marginal``. Constructors return an ``LGSSM`` of
tensors in ``default_dtype()``, on the device of a tensor argument or
on ``device`` (default ``"cuda"``); observation noise r is a scalar or
per-step (T,).
"""

import math
from typing import NamedTuple

import torch

from exmc_tpu_torch.config import default_dtype, prepare_device

LOG_2PI = math.log(2.0 * math.pi)


class LGSSM(NamedTuple):
    F: torch.Tensor      # (m, m) transition
    Q: torch.Tensor      # (m, m) innovation covariance
    h: torch.Tensor      # (m,) observation row
    r: torch.Tensor      # scalar (or (T,)) observation variance
    mu0: torch.Tensor    # (m,) initial mean
    P0: torch.Tensor     # (m, m) initial covariance


def _device(*xs, device):
    """The device of the first tensor among ``xs``, else ``device``."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return prepare_device(device)


def _dt(x, dtype, device):
    return torch.as_tensor(x, dtype=dtype, device=device)


def stationary_cov(F, Q):
    """Solve the discrete Lyapunov equation P = F P F' + Q exactly by
    the vec trick: (I - F (x) F) vec(P) = vec(Q). F and Q may carry
    leading batch axes (..., m, m)."""
    m = F.shape[-1]
    batch = torch.broadcast_shapes(F.shape[:-2], Q.shape[:-2])
    kron = torch.einsum("...ij,...kl->...ikjl", F, F).reshape(*F.shape[:-2], m * m, m * m)
    eye = torch.eye(m * m, dtype=F.dtype, device=F.device)
    rhs = torch.broadcast_to(Q, (*batch, m, m)).reshape(*batch, m * m, 1)
    P = torch.linalg.solve(eye - kron, rhs).reshape(*batch, m, m)
    return 0.5 * (P + P.transpose(-1, -2))


def grw_ssm(sigma, dtype=None, device=None):
    """GaussianRandomWalk(sigma) in state-space form (m=1), with the
    library convention x_1 ~ N(0, sigma^2)."""
    dtype = dtype or default_dtype()
    dev = _device(sigma, device=device)
    s2 = _dt(sigma, dtype, dev) ** 2
    one = torch.ones(1, 1, dtype=dtype, device=dev)
    return LGSSM(F=one, Q=s2 * one, h=torch.ones(1, dtype=dtype, device=dev),
                 r=torch.zeros((), dtype=dtype, device=dev),
                 mu0=torch.zeros(1, dtype=dtype, device=dev), P0=s2 * one)


# The constructors build their matrices from device ops only (no
# indexed writes of host scalars), so the AR(p) marginal, which calls
# ar_ssm inside a log-density, can be captured in a CUDA graph.

def _companion(first_row, m, dtype, dev, batch=()):
    """[[first_row], [I_{m-1} 0]] with leading batch axes."""
    first = torch.broadcast_to(torch.as_tensor(first_row, dtype=dtype, device=dev),
                               (*batch, m)).unsqueeze(-2)
    shift = torch.eye(m, dtype=dtype, device=dev)[: m - 1].expand(*batch, m - 1, m)
    return torch.cat([first, shift], dim=-2)


def _first_only(value, m, dtype, dev, batch=()):
    """The (m, m) matrix with ``value`` at [0, 0] and zeros elsewhere."""
    e0 = torch.eye(m, dtype=dtype, device=dev)[0]
    return value[..., None, None] * (e0[:, None] * e0[None, :]).expand(*batch, m, m)


def _e0(m, dtype, dev):
    return torch.eye(m, dtype=dtype, device=dev)[0]


def ar_ssm(phis, sigma, dtype=None, device=None):
    """Stationary AR(p) in companion form: state (s_t, ..., s_{t-p+1}),
    the observation picks the first coordinate. ``phis``: (p,)
    coefficients, stationary (the Lyapunov solve gives the stationary
    initial distribution exactly). ``phis`` (..., p) and ``sigma`` (...)
    may carry leading batch axes, which F, Q and P0 then carry."""
    dtype = dtype or default_dtype()
    dev = _device(phis, sigma, device=device)
    phis = torch.atleast_1d(_dt(phis, dtype, dev))
    sigma = _dt(sigma, dtype, dev)
    p = phis.shape[-1]
    batch = torch.broadcast_shapes(phis.shape[:-1], sigma.shape)
    F = _companion(phis, p, dtype, dev, batch)
    Q = _first_only(sigma ** 2, p, dtype, dev, batch)
    return LGSSM(F=F, Q=Q, h=_e0(p, dtype, dev), r=torch.zeros((), dtype=dtype, device=dev),
                 mu0=torch.zeros(p, dtype=dtype, device=dev), P0=stationary_cov(F, Q))


def seasonal_ssm(period, sigma_seas, dtype=None, device=None):
    """Seasonal-dummy component: the m = period-1 state makes
    consecutive seasonal effects sum to ~N(0, sigma_seas^2):
        gamma_t = -(gamma_{t-1} + ... + gamma_{t-period+1}) + w_t."""
    dtype = dtype or default_dtype()
    dev = _device(sigma_seas, device=device)
    m = int(period) - 1
    s = _dt(sigma_seas, dtype, dev)
    F = _companion(-torch.ones(m, dtype=dtype, device=dev), m, dtype, dev)
    Q = _first_only(s ** 2, m, dtype, dev)
    h = _e0(m, dtype, dev)
    # unit-modulus eigenvalues: no stationary distribution, so a
    # diffuse-ish proper prior
    P0 = 1e4 * s ** 2 * torch.eye(m, dtype=dtype, device=dev)
    return LGSSM(F=F, Q=Q, h=h, r=torch.zeros((), dtype=dtype, device=dev),
                 mu0=torch.zeros(m, dtype=dtype, device=dev), P0=P0)


def add_obs_noise(ssm, r):
    """Return the model with observation variance r (scalar or (T,))."""
    return ssm._replace(r=torch.as_tensor(r, dtype=ssm.F.dtype, device=ssm.F.device))


def kalman_filter(ssm, ys):
    """Exact filtering of x_t | y_{1:t}. Returns
    ``(loglik, (means (T, m), covs (T, m, m), mu_pred (T, m),
    P_pred (T, m, m)))``: the exact marginal log p(y_{1:T}), the
    filtered moments and the one-step predictions (at t = 1 the
    prior)."""
    dtype, dev = ssm.F.dtype, ssm.F.device
    ys = torch.as_tensor(ys, dtype=dtype, device=dev)
    T = ys.shape[0]
    rs = torch.broadcast_to(ssm.r, (T,))
    F, Q, h = ssm.F, ssm.Q, ssm.h
    mu, P = ssm.mu0, ssm.P0
    lls, mus, Ps, mu_pred, P_pred = [], [], [], [], []
    for t in range(T):
        if t > 0:
            mu = F @ mu
            P = F @ P @ F.T + Q
        mu_pred.append(mu)
        P_pred.append(P)
        s = h @ P @ h + rs[t]
        k = (P @ h) / s
        resid = ys[t] - h @ mu
        mu = mu + k * resid
        P = P - torch.outer(k, h @ P)
        lls.append(-0.5 * (LOG_2PI + torch.log(s) + resid * resid / s))
        mus.append(mu)
        Ps.append(P)
    st = torch.stack
    return st(lls).sum(), (st(mus), st(Ps), st(mu_pred), st(P_pred))


def kalman_loglik(ssm, ys):
    """Exact marginal log p(y_{1:T})."""
    ll, _ = kalman_filter(ssm, ys)
    return ll


def kalman_smoother(ssm, ys):
    """RTS smoothing: returns (means (T, m), covs (T, m, m)) of
    x_t | y_{1:T}."""
    _, (mus, Ps, mu_pred, P_pred) = kalman_filter(ssm, ys)
    T = mus.shape[0]
    mu_s, P_s = [mus[-1]], [Ps[-1]]
    for t in range(T - 2, -1, -1):
        # gain J_t = P_f F' P_pred_{t+1}^{-1}
        J = torch.linalg.solve(P_pred[t + 1], ssm.F @ Ps[t]).T
        mu_s.append(mus[t] + J @ (mu_s[-1] - mu_pred[t + 1]))
        P_s.append(Ps[t] + J @ (P_s[-1] - P_pred[t + 1]) @ J.T)
    return torch.stack(mu_s[::-1]), torch.stack(P_s[::-1])
