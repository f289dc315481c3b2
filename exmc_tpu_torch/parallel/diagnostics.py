"""Cross-rank diagnostics (``exmc_tpu/parallel/diagnostics.py``): split
R-hat, nested R-hat and ESS over chains sharded across ranks.

Each rank passes its own (local chains, n) block; it reduces its chains
and one ``all_reduce`` per pass combines the moments, so no draw matrix
leaves its rank. The between-chain variance is centred two-pass: the
grand mean first, then the sum of squared deviations from it. The
one-pass E[x^2] - E[x]^2 form cancels catastrophically in f32 for a
posterior with a large common offset (a mean near 1e3 leaves ~0.1 of f32
rounding noise against a true between-variance of ~1e-4). Every rank
gets the same result, a numpy 0-d array as from ``diagnostics``; numpy
input is computed on the CPU in its own dtype, as there.
"""

import numpy as np
import torch

from exmc_tpu_torch.diagnostics import _geyer_tau, _split_chains, _var, autocovariance


def _local(draws):
    x = torch.as_tensor(draws)
    if x.ndim != 2:
        raise ValueError(f"expected this rank's (chains, draws) block, got shape "
                         f"{tuple(x.shape)}")
    return x


def _chain_counts(axis, c_local):
    """Every rank's chain count along the axis (a host list), by one
    ``all_reduce`` of a one-hot vector."""
    counts = torch.zeros(axis.size, dtype=torch.float64)
    counts[axis.index] = c_local
    (counts,) = axis.psum(counts)
    return [int(v) for v in counts.tolist()]


def _scalar(x, like):
    return torch.as_tensor(float(x), dtype=like.dtype, device=like.device)


def sharded_rhat(draws, mesh, axis="dp"):
    """Split-chain R-hat of the chains of every rank along ``axis``;
    ``draws`` is this rank's (chains, n) block. Matches
    ``diagnostics.rhat`` of the gathered chains."""
    grp = mesh.axis(axis)
    s = _split_chains(_local(draws))
    m_local, n = s.shape
    means = s.mean(dim=1)
    vars_ = _var(s, 1)
    cnt, mean_sum = grp.psum(_scalar(m_local, s), means.sum())
    grand = mean_sum / cnt
    b_sum, w_sum = grp.psum(((means - grand) ** 2).sum(), vars_.sum())
    w = w_sum / cnt
    b = n * b_sum / (cnt - 1.0)
    var_plus = (n - 1) / n * w + b / n
    return np.asarray(torch.sqrt(var_plus / torch.clamp_min(w, 1e-30)).cpu().numpy())


def sharded_nested_rhat(draws, mesh, num_superchains, axis="dp"):
    """Nested R-hat (Margossian 2022) of the chains of every rank along
    ``axis``, superchains grouped consecutively across the global chain
    order as ``diagnostics.nested_rhat`` groups them; ``draws`` is this
    rank's (chains, n) block.

    Each rank must hold whole superchains: the chains split evenly over
    the ranks (c % n_dev == 0, which the JAX package does not check) and
    each rank's chains a whole number of superchains of c / K."""
    grp = mesh.axis(axis)
    x = _local(draws)
    c_local, n = x.shape
    counts = _chain_counts(grp, c_local)
    c = sum(counts)
    n_dev = grp.size
    if c % n_dev != 0 or any(k != c // n_dev for k in counts):
        raise ValueError(f"the {c} chains are not split evenly over the {n_dev} "
                         f"'{axis}' ranks (per rank: {counts})")
    k = int(num_superchains)
    if k < 2:
        raise ValueError("need >= 2 superchains")
    if c % k != 0:
        raise ValueError(f"chains ({c}) not divisible by k ({k})")
    m = c // k
    if m < 2:
        raise ValueError("need >= 2 chains per superchain")
    if c_local % m != 0:
        raise ValueError(
            f"each of the {n_dev} '{axis}' shards holds {c_local} chains, not a "
            f"whole number of size-{m} superchains")
    g = x.reshape(-1, m, n)
    chain_means = g.mean(dim=2)
    within_chain = (_var(g, 2).mean(dim=1) if n > 1
                    else torch.zeros(g.shape[0], dtype=x.dtype, device=x.device))
    super_means = chain_means.mean(dim=1)
    cnt, super_sum = grp.psum(_scalar(g.shape[0], x), super_means.sum())
    grand = super_sum / cnt
    w_terms = _var(chain_means, 1) + within_chain
    b_sum, w_sum = grp.psum(((super_means - grand) ** 2).sum(), w_terms.sum())
    b = b_sum / (cnt - 1.0)
    w = w_sum / cnt
    return np.asarray(torch.sqrt(1.0 + b / torch.clamp_min(w, 1e-30)).cpu().numpy())


def sharded_ess(draws, mesh, axis="dp"):
    """Pooled-chain Geyer ESS of the chains of every rank along
    ``axis``: each rank's autocovariances by FFT, the pooled moments by
    ``all_reduce``. Matches ``diagnostics.ess`` of the gathered chains
    (var_plus with the between-chain term, Vehtari 2021)."""
    grp = mesh.axis(axis)
    x = _local(draws)
    c_local, n = x.shape
    c_total = sum(_chain_counts(grp, c_local))
    acov = autocovariance(x)
    cnt = _scalar(c_total, x)
    (acov_sum,) = grp.psum(acov.sum(dim=0))
    mean_acov = acov_sum / cnt
    w_biased = mean_acov[0]
    mean_var = w_biased * n / (n - 1.0)
    var_plus = w_biased
    if c_total > 1:
        chain_means = x.mean(dim=1)
        (mean_sum,) = grp.psum(chain_means.sum())
        grand = mean_sum / cnt
        (b_sum,) = grp.psum(((chain_means - grand) ** 2).sum())
        var_plus = var_plus + b_sum / (cnt - 1.0)
    rho = 1.0 - (mean_var - mean_acov) / torch.clamp_min(var_plus, 1e-30)
    rho[0] = 1.0
    n_pairs = n // 2
    pair = rho[0: 2 * n_pairs: 2] + rho[1: 2 * n_pairs: 2]
    return np.asarray((cnt * n / _geyer_tau(pair, n)).cpu().numpy())
