"""MCMC diagnostics (``exmc_tpu/diagnostics.py:26-189``): ``ess`` (Geyer
initial positive/monotone sequence over an FFT autocovariance), split
``rhat`` and ``nested_rhat``.

Inputs are (chains, draws) arrays or tensors; numpy input is computed on
the CPU in its own dtype. Bulk/tail ESS, E-BFMI and ``summary`` are not
ported yet (ROADMAP §1 item 4).
"""

import math

import torch


def _as_2d(x):
    x = torch.as_tensor(x)
    return x.reshape(1, -1) if x.ndim == 1 else x


def _var(x, dim):
    return torch.var(x, dim=dim, correction=1)


def autocovariance(x):
    """Per-chain autocovariance via FFT. x: (..., n) -> (..., n), with
    the biased /n divisor."""
    n = x.shape[-1]
    x = x - x.mean(dim=-1, keepdim=True)
    m = int(2 ** math.ceil(math.log2(2 * n)))
    f = torch.fft.rfft(x, n=m, dim=-1)
    acov = torch.fft.irfft(f * torch.conj(f), n=m, dim=-1)[..., :n]
    return (acov / n).to(x.dtype)


def _split_chains(x):
    """(chains, draws) -> (2*chains, draws//2) split-chain view."""
    c, n = x.shape
    half = n // 2
    return x[:, : 2 * half].reshape(c * 2, half)


def _geyer_tau(pair, n):
    """Integrated autocorrelation time from Geyer pair sums."""
    keep = torch.cumprod((pair > 0.0).to(pair.dtype), dim=0)
    inf = torch.full_like(pair, math.inf)
    mono = torch.cummin(torch.where(keep > 0, pair, inf), dim=0).values
    tau = -1.0 + 2.0 * torch.sum(torch.where(keep > 0, mono, torch.zeros_like(mono)))
    return torch.clamp_min(tau, 1.0 / math.log10(float(n)))


def ess(x):
    """Effective sample size, Geyer initial positive/monotone sequence,
    pooled over chains with var_plus = W*(n-1)/n + B/n (Vehtari et al.
    2021). x: (chains, draws) or (draws,)."""
    x = _as_2d(x)
    c, n = x.shape
    acov = autocovariance(x)
    mean_acov = acov.mean(dim=0)
    w_biased = acov[:, 0].mean()
    mean_var = w_biased * n / (n - 1.0)
    var_plus = w_biased
    if c > 1:
        var_plus = var_plus + _var(x.mean(dim=1), 0)
    rho = 1.0 - (mean_var - mean_acov) / torch.clamp_min(var_plus, 1e-30)
    rho[0] = 1.0
    n_pairs = n // 2
    pair = rho[0: 2 * n_pairs: 2] + rho[1: 2 * n_pairs: 2]
    return c * n / _geyer_tau(pair, n)


def rhat(x):
    """Split-chain R-hat. x: (chains, draws)."""
    s = _split_chains(_as_2d(x))
    m, n = s.shape
    w = _var(s, 1).mean()
    b = n * _var(s.mean(dim=1), 0)
    var_plus = (n - 1) / n * w + b / n
    return torch.sqrt(var_plus / torch.clamp_min(w, 1e-30))


def nested_rhat(x, num_superchains):
    """Nested R-hat (Margossian et al. 2022) for many short chains.

    ``x``: (chains, draws); chains are grouped CONSECUTIVELY into
    ``num_superchains`` superchains of M = chains / num_superchains.

        nRhat = sqrt(1 + B/W)
        B = var_k(superchain means)                              (ddof=1)
        W = mean_k [var_{m in k}(chain means) + mean_m(within var)]
    """
    x = _as_2d(x)
    c, n = x.shape
    k = int(num_superchains)
    if k < 2:
        raise ValueError("need >= 2 superchains (B is a between-superchain "
                         "variance; k=1 would return nan)")
    if c % k != 0:
        raise ValueError(f"chains ({c}) not divisible by num_superchains ({k})")
    m = c // k
    if m < 2:
        raise ValueError("need >= 2 chains per superchain")
    g = x.reshape(k, m, n)
    chain_means = g.mean(dim=2)
    within_chain = (_var(g, 2).mean(dim=1) if n > 1
                    else torch.zeros(k, dtype=x.dtype, device=x.device))
    super_means = chain_means.mean(dim=1)
    b = _var(super_means, 0)
    w = (_var(chain_means, 1) + within_chain).mean()
    return torch.sqrt(1.0 + b / torch.clamp_min(w, 1e-30))
