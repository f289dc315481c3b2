"""Welford online (co)variance for the mass matrix
(``exmc_tpu/nuts/mass_matrix.py``).

Per-chain state: n (C,), mean (C, d), m2 (C, d), or (C, d, d) for the
dense metric (a sum of outer products). Stan shrinkage
``(n/(n+5))*var + (5/(n+5))*1e-3`` with a 1e-6 floor (dense: toward
1e-3 I, plus 1e-6 I).
"""

from typing import NamedTuple

import torch

from exmc_tpu_torch.config import default_dtype

class WelfordState(NamedTuple):
    n: torch.Tensor       # (C,) counts, or () after a merge
    mean: torch.Tensor    # (C, d) or (d,)
    m2: torch.Tensor      # (C, d) or (d,); dense (C, d, d) or (d, d)


def welford_init(c, d, dtype=None, device=None, dense=False):
    dtype = default_dtype() if dtype is None else dtype
    return WelfordState(
        n=torch.zeros(c, dtype=dtype, device=device),
        mean=torch.zeros(c, d, dtype=dtype, device=device),
        m2=torch.zeros((c, d, d) if dense else (c, d), dtype=dtype, device=device),
    )


def welford_update(state: WelfordState, x, enabled):
    """Online update of each chain with its row of ``x`` (C, d); a chain
    whose ``enabled`` is False (e.g. a divergent draw) keeps its state.
    The blend multiplies by 0/1 instead of selecting, as the JAX package
    does, so the bits match (a non-finite x reaches the state either
    way)."""
    n = state.n + 1.0
    delta = x - state.mean
    mean = state.mean + delta / n[:, None]
    delta2 = x - mean
    dense = state.m2.ndim == 3
    if dense:
        m2 = state.m2 + delta[:, :, None] * delta2[:, None, :]
    else:
        m2 = state.m2 + delta * delta2
    w = enabled.to(x.dtype)
    wc = w[:, None]
    wm = w[:, None, None] if dense else wc
    return WelfordState(
        n=state.n * (1 - w) + n * w,
        mean=state.mean * (1 - wc) + mean * wc,
        m2=state.m2 * (1 - wm) + m2 * wm,
    )


def welford_merge_across(state: WelfordState, group=None) -> WelfordState:
    """Merge the per-chain states over dim 0 as if all chains' draws were
    one stream (Chan et al. parallel variance). Returns one state with
    no chain axis: n (), mean (d,), m2 (d,).

    ``group`` (a ``parallel.sharding.AxisGroup``) merges the chains of
    every rank along it, two-pass and centred as in one process: one
    ``all_reduce`` of (sum n, sum n * mean) gives the global mean, a
    second one of sum (m2 + n (mean - global mean)^2). The one-pass
    E[x^2] - E[x]^2 form would cancel in f32 at large offsets."""
    n_tot = state.n.sum(0)
    mean_sum = (state.n[:, None] * state.mean).sum(0)
    if group is not None:
        n_tot, mean_sum = group.psum(n_tot, mean_sum)
    safe = torch.clamp_min(n_tot, 1.0)
    mean_tot = mean_sum / safe
    delta = state.mean - mean_tot
    if state.m2.ndim == 3:
        corr = state.n[:, None, None] * delta[:, :, None] * delta[:, None, :]
    else:
        corr = state.n[:, None] * delta * delta
    m2_tot = (state.m2 + corr).sum(0)
    if group is not None:
        (m2_tot,) = group.psum(m2_tot)
    return WelfordState(n=n_tot, mean=mean_tot, m2=m2_tot)


def welford_finalize(state: WelfordState, prev):
    """Finalize to a variance (or, dense, a covariance) with Stan
    shrinkage and floor; keeps ``prev`` where fewer than 2 samples
    accumulated. Broadcasts a merged (chain-less) state against a
    per-chain ``prev`` (C, d) or (C, d, d)."""
    if state.m2.ndim == state.mean.ndim + 1:
        cnt = state.n.unsqueeze(-1).unsqueeze(-1)
        n = torch.clamp_min(cnt, 2.0)
        alpha = 5.0 / (cnt + 5.0)
        d = state.m2.shape[-1]
        eye = torch.eye(d, dtype=state.m2.dtype, device=state.m2.device)
        cov = state.m2 / (n - 1.0)
        shrunk = (1.0 - alpha) * cov + alpha * 1e-3 * eye
        shrunk = shrunk + 1e-6 * eye
        return torch.where(cnt >= 2.0, shrunk, prev)
    cnt = state.n.unsqueeze(-1)
    n = torch.clamp_min(cnt, 2.0)
    alpha = 5.0 / (cnt + 5.0)
    var = state.m2 / (n - 1.0)
    shrunk = (1.0 - alpha) * var + alpha * 1e-3
    shrunk = torch.clamp_min(shrunk, 1e-6)
    return torch.where(cnt >= 2.0, shrunk, prev)
