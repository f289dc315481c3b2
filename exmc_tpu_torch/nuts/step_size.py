"""Dual-averaging step-size adaptation (``exmc_tpu/nuts/step_size.py``).

Constants: gamma=0.05, t0=10, kappa=0.75, mu=log(10*eps0);
``log_eps_bar`` starts from log(eps), not 0. The state holds one value
per chain: every field is (C,).
"""

import math
from typing import NamedTuple

import torch

from exmc_tpu_torch.nuts.leapfrog import kinetic_energy, leapfrog, sample_momentum
from exmc_tpu_torch.nuts.masked import HostSyncs, keep

GAMMA = 0.05
T0 = 10.0
KAPPA = 0.75


class DualAveragingState(NamedTuple):
    mu: torch.Tensor
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    t: torch.Tensor


def da_init(eps):
    log_eps = torch.log(eps)
    return DualAveragingState(
        mu=torch.log(10.0 * eps),
        log_eps=log_eps,
        log_eps_bar=log_eps,
        h_bar=torch.zeros_like(log_eps),
        t=torch.zeros_like(log_eps),
    )


def da_update(state: DualAveragingState, accept_prob, target_accept):
    """One dual-averaging update."""
    accept_prob = torch.where(torch.isfinite(accept_prob), accept_prob,
                              torch.zeros_like(accept_prob))
    t = state.t + 1.0
    w = 1.0 / (t + T0)
    h_bar = (1.0 - w) * state.h_bar + w * (target_accept - accept_prob)
    log_eps = state.mu - torch.sqrt(t) / GAMMA * h_bar
    eta = t ** -KAPPA
    log_eps_bar = eta * log_eps + (1.0 - eta) * state.log_eps_bar
    return DualAveragingState(state.mu, log_eps, log_eps_bar, h_bar, t)


def da_finalize(state: DualAveragingState):
    return torch.exp(state.log_eps_bar)


def find_reasonable_epsilon(vag_fn, q, logp, grad, metric, z, eps0=1.0,
                            max_iters=100, syncs=None):
    """Double/halve each chain's epsilon until its one-step acceptance
    crosses 0.5, as a per-chain masked loop. ``z`` (C, d) are the
    standard normals of the momentum draw. NaN-safe: a non-finite delta
    counts as delta=-inf (halve). Returns (C,) step sizes."""
    syncs = HostSyncs() if syncs is None else syncs
    r = sample_momentum(metric, z)
    joint0 = logp - kinetic_energy(metric, r)
    log_half = math.log(0.5)
    neg_inf = torch.full_like(logp, -math.inf)

    def delta_at(eps):
        _, r1, logp1, _ = leapfrog(vag_fn, q, r, grad, eps[:, None], metric)
        d = (logp1 - kinetic_energy(metric, r1)) - joint0
        return torch.where(torch.isfinite(d), d, neg_inf)

    eps = torch.full_like(logp, eps0)
    d = delta_at(eps)
    direction = torch.where(d > log_half, 1.0, -1.0).to(eps.dtype)
    i = 0
    while True:
        crossed = torch.where(direction > 0, d <= log_half, d > log_half)
        active = (~crossed) & (eps > 1e-10) & (eps < 1e7)
        # every active chain has run exactly i iterations, so the
        # per-chain ``i < max_iters`` test is one host test here
        if i >= max_iters or not syncs.any(active):
            break
        eps_new = eps * torch.exp2(direction)
        d = keep(active, delta_at(eps_new), d)
        eps = keep(active, eps_new, eps)
        i += 1
    eps = torch.where(direction > 0, eps * 0.5, eps)
    return torch.clamp(eps, 1e-10, 1e7)
