"""Leapfrog integrator and metric (``exmc_tpu/nuts/leapfrog.py``).

Batched over chains: q, p, grad are (C, d). A diagonal metric's ``inv``
is (C, d) (one inverse mass per chain) or (d,) shared by all; a dense
one's is (C, d, d), and its velocity is a batched mat-vec. We carry
logp, not potential energy, so the kick uses +grad(logp).
"""

from typing import NamedTuple

import torch


class Metric(NamedTuple):
    """Euclidean metric. ``inv`` is the inverse mass; ``chol_inv`` caches
    sqrt(inv) (diagonal) or cholesky(inv) (dense) for momentum sampling."""

    inv: torch.Tensor
    chol_inv: torch.Tensor
    dense: bool = False


def make_metric(inv, dense=False) -> Metric:
    if dense:
        return Metric(inv=inv, chol_inv=torch.linalg.cholesky(inv), dense=True)
    return Metric(inv=inv, chol_inv=torch.sqrt(inv))


def velocity(metric: Metric, p):
    """v = M^{-1} p."""
    if metric.dense:
        return torch.matmul(metric.inv, p.unsqueeze(-1)).squeeze(-1)
    return metric.inv * p


def velocity_rows(metric: Metric, r):
    """v = M^{-1} r for every row of r (C, k, d), each chain's rows
    under its own metric."""
    if metric.dense:
        return torch.matmul(r, metric.inv.transpose(-1, -2))
    return metric.inv.unsqueeze(-2) * r


def kinetic_energy(metric: Metric, p):
    """K = 0.5 p^T M^{-1} p, per chain: (C, d) -> (C,)."""
    return 0.5 * torch.sum(p * velocity(metric, p), dim=-1)


def sample_momentum(metric: Metric, z):
    """p ~ N(0, M) from standard normals ``z`` (C, d): p = z / sqrt(M^{-1})
    (diagonal), or p = L^{-T} z with M^{-1} = L L^T (dense).

    A diagonal entry inv == 0 FREEZES that coordinate (infinite mass): its
    momentum is 0, so it never drifts and adds no kinetic energy."""
    if metric.dense:
        return torch.linalg.solve_triangular(
            metric.chol_inv.transpose(-1, -2), z.unsqueeze(-1),
            upper=True).squeeze(-1)
    return torch.where(metric.chol_inv > 0, z / metric.chol_inv,
                       torch.zeros_like(z))


def leapfrog(vag_fn, q, p, grad, eps, metric: Metric):
    """One leapfrog step. ``vag_fn(q) -> (logp, grad)``; ``eps`` is a
    scalar or a (C, 1) column of per-chain (signed) step sizes.

    Returns (q1, p1, logp1, grad1)."""
    p_half = p + 0.5 * eps * grad
    q1 = q + eps * velocity(metric, p_half)
    logp1, grad1 = vag_fn(q1)
    p1 = p_half + 0.5 * eps * grad1
    return q1, p1, logp1, grad1
