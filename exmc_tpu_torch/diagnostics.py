"""MCMC diagnostics (``exmc_tpu/diagnostics.py``): ``ess`` (Geyer
initial positive/monotone sequence over an FFT autocovariance),
``ess_bulk``/``ess_tail`` and ``rhat_bulk`` (Blom rank-normalized, ties
at their average rank), split ``rhat``, ``nested_rhat``, ``ebfmi``,
``autocorrelation``, ``quantile`` and ``summary``.

Inputs are (chains, draws) arrays or tensors; numpy input is computed on
the CPU in its own dtype. Between-chain variances are centered two-pass
(``torch.var``).

The public statistics return numpy arrays (0-d for a scalar), as
``np.asarray`` of the JAX package's results would be, so numpy's
reductions and ``float`` work on them; ``summary`` returns Python
floats. The package's own callers use the private tensor versions
(``_ess``, ``_rhat``, ...), which leave a result on its device.
"""

import math

import numpy as np
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


def _ess(x):
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


def _rank_normalize(x):
    """Blom rank-normalization + probit over all draws; ties get their
    average rank."""
    x = torch.as_tensor(x)
    flat = x.reshape(-1).contiguous()
    n = flat.shape[0]
    sorted_x = torch.sort(flat).values
    left = torch.searchsorted(sorted_x, flat, right=False)
    right = torch.searchsorted(sorted_x, flat, right=True)
    ranks = 0.5 * (left + right + 1.0).to(x.dtype)
    u = (ranks - 0.375) / (n + 0.25)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return z.reshape(x.shape)


def _ess_bulk(x):
    """Bulk ESS: rank-normalized split-chain ESS."""
    return _ess(_split_chains(_rank_normalize(_as_2d(x))))


def _ess_tail(x, prob=0.05):
    """Tail ESS: the smaller ESS of the prob and 1 - prob quantile
    indicators."""
    x = _as_2d(x)
    lo, hi = _quantile(x, [prob, 1.0 - prob])
    e_lo = _ess(_split_chains(_rank_normalize((x <= lo).to(x.dtype))))
    e_hi = _ess(_split_chains(_rank_normalize((x <= hi).to(x.dtype))))
    return torch.minimum(e_lo, e_hi)


def _rhat(x):
    """Split-chain R-hat. x: (chains, draws)."""
    s = _split_chains(_as_2d(x))
    m, n = s.shape
    w = _var(s, 1).mean()
    b = n * _var(s.mean(dim=1), 0)
    var_plus = (n - 1) / n * w + b / n
    return torch.sqrt(var_plus / torch.clamp_min(w, 1e-30))


def _rhat_bulk(x):
    """Rank-normalized split R-hat."""
    return _rhat(_rank_normalize(_as_2d(x)))


def _nested_rhat(x, num_superchains):
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


def _ebfmi(energy):
    """Energy Bayesian fraction of missing information per chain
    (Betancourt 2016): mean(diff(E)^2) / var(E). ``energy``: (chains,
    draws), e.g. ``stats["energy"]``; returns (chains,)."""
    e = _as_2d(energy)
    de = torch.diff(e, dim=1)
    return (de * de).mean(dim=1) / _var(e, 1)


def _autocorrelation(x, max_lag=None):
    """Normalized autocorrelation per chain (FFT)."""
    acov = autocovariance(torch.as_tensor(x))
    acf = acov / torch.clamp_min(acov[..., :1], 1e-30)
    return acf if max_lag is None else acf[..., : max_lag + 1]


def _quantile(x, qs):
    """Quantiles of all draws by sorted linear interpolation (numpy's and
    JAX's default "linear" method)."""
    flat = torch.sort(torch.as_tensor(x).reshape(-1)).values
    q = torch.as_tensor(qs, dtype=flat.dtype, device=flat.device)
    pos = q * (flat.shape[0] - 1)
    lo = torch.floor(pos).long()
    hi = torch.clamp_max(lo + 1, flat.shape[0] - 1)
    return flat[lo] + (flat[hi] - flat[lo]) * (pos - lo.to(flat.dtype))


def summary(trace, var_names=None):
    """Per-parameter table: mean, std, q5/q25/q50/q75/q95, ess,
    ess_bulk, ess_tail, rhat and mcse_mean = std / sqrt(ess).
    ``trace``: {name: (chains, draws, *event)}; a vector parameter is
    summarized per flattened component ``name[i]``."""
    out = {}
    for name in (var_names if var_names is not None else sorted(trace)):
        arr = torch.as_tensor(np.asarray(trace[name]))
        c, n = arr.shape[0], arr.shape[1]
        flat_ev = arr.reshape(c, n, -1)
        for i in range(flat_ev.shape[-1]):
            x = flat_ev[:, :, i]
            key = name if flat_ev.shape[-1] == 1 else f"{name}[{i}]"
            qs = _quantile(x, [0.05, 0.25, 0.5, 0.75, 0.95])
            row = {"mean": float(x.mean()), "std": float(torch.std(x, correction=1))}
            row.update({f"q{p}": float(v) for p, v in zip((5, 25, 50, 75, 95), qs)})
            row.update(ess=float(_ess(x)), ess_bulk=float(_ess_bulk(x)),
                       ess_tail=float(_ess_tail(x)), rhat=float(_rhat(x)))
            row["mcse_mean"] = row["std"] / max(row["ess"], 1.0) ** 0.5
            out[key] = row
    return out


def _numpy(fn):
    """The public form of a tensor statistic: the same computation, its
    result as a numpy array on the host."""

    def public(*args, **kwargs):
        return fn(*args, **kwargs).detach().cpu().numpy()

    public.__name__ = fn.__name__[1:]
    public.__qualname__ = public.__name__
    public.__doc__ = fn.__doc__
    return public


ess = _numpy(_ess)
ess_bulk = _numpy(_ess_bulk)
ess_tail = _numpy(_ess_tail)
rhat = _numpy(_rhat)
rhat_bulk = _numpy(_rhat_bulk)
nested_rhat = _numpy(_nested_rhat)
ebfmi = _numpy(_ebfmi)
autocorrelation = _numpy(_autocorrelation)
quantile = _numpy(_quantile)
