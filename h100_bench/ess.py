"""Bulk effective sample size in numpy: rank-normalised split-chain ESS
with Geyer's initial positive and monotone sequence (Vehtari et al.
2021). The same arithmetic as the port's ``diagnostics._ess_bulk``, kept
here so that the yardstick does not change with the program."""

import math

import numpy as np
from scipy.special import ndtri


def ess(x):
    """ESS of a (chains, draws) array, pooled over chains with
    var_plus = W * (n - 1) / n + B / n."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[None]
    c, n = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    m = 2 ** math.ceil(math.log2(2 * n))
    f = np.fft.rfft(xc, n=m, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=m, axis=1)[:, :n] / n
    mean_acov = acov.mean(axis=0)
    w_biased = acov[:, 0].mean()
    mean_var = w_biased * n / (n - 1.0)
    var_plus = w_biased + (x.mean(axis=1).var(ddof=1) if c > 1 else 0.0)
    rho = 1.0 - (mean_var - mean_acov) / max(var_plus, 1e-30)
    rho[0] = 1.0
    pairs = n // 2
    pair = rho[0:2 * pairs:2] + rho[1:2 * pairs:2]
    keep = np.cumprod(pair > 0.0)
    mono = np.minimum.accumulate(np.where(keep > 0, pair, np.inf))
    tau = -1.0 + 2.0 * np.sum(np.where(keep > 0, mono, 0.0))
    return c * n / max(tau, 1.0 / math.log10(n))


def rank_normalize(x):
    """Blom ranks over all draws, ties at their average rank, then the
    normal quantile."""
    x = np.asarray(x, np.float64)
    flat = x.ravel()
    s = np.sort(flat)
    ranks = 0.5 * (np.searchsorted(s, flat, "left")
                   + np.searchsorted(s, flat, "right") + 1.0)
    return ndtri((ranks - 0.375) / (flat.size + 0.25)).reshape(x.shape)


def split_chains(x):
    """(chains, draws) -> (2 * chains, draws // 2): each chain's halves."""
    c, n = x.shape
    half = n // 2
    return x[:, :2 * half].reshape(2 * c, half)


def ess_bulk(x):
    """Bulk ESS of a (chains, draws) array."""
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[None]
    return ess(split_chains(rank_normalize(x)))


def scalar_columns(trace):
    """{name: (chains, draws, *shape)} -> [(label, (chains, draws))], one
    entry per scalar parameter."""
    out = []
    for name in sorted(trace):
        v = np.asarray(trace[name])
        flat = v.reshape(v.shape[0], v.shape[1], -1)
        if flat.shape[2] == 1 and v.ndim == 2:
            out.append((name, flat[:, :, 0]))
        else:
            out.extend((f"{name}[{j}]", flat[:, :, j]) for j in range(flat.shape[2]))
    return out
