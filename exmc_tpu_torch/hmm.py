"""Hidden Markov models by exact marginalization (``exmc_tpu/hmm.py``).

* :func:`forward_logp`: log p(y_1:T) by the forward algorithm;
* :func:`hmm_dist`: a ``Custom`` distribution over the WHOLE observed
  sequence, so NUTS samples only the continuous parameters;
* :func:`posterior_state_probs`: forward-backward smoothing
  gamma_t(k) = p(s_t = k | y, theta) for one parameter draw;
* :func:`viterbi`: the MAP state path for one parameter draw.

The JAX package's forward pass is a ``lax.scan`` of T - 1 (K, K)
logsumexp contractions. Here it is a log-depth tree: the T - 1 steps are
log-space matrices M_t[i, j] = log_trans[i, j] + log_obs[t, j], and
their product (under logsumexp-plus) is reduced pairwise in
ceil(log2 T) levels of batched contractions, so a CUDA graph of the
log-density holds ~10 levels, not T steps. The sum is the same; its
rounding order differs from the scan's (f32: ~1e-5 relative).

``hmm_dist``'s density sees the sampler's (C, ...) batch, like every
``Custom`` (unaligned: ``align=False``); it applies the user's emission
to one point at a time (``torch.func.vmap`` over the chain axis, as det
callables are) and runs the forward pass on the whole batch, so
``emission_logpdf(y, k, params)`` indexes per-state parameters as
``params["mu"][k]``, as in the JAX package. Label switching: give
state-indexed location parameters an ``ordered`` transform.
"""

import torch

from exmc_tpu_torch.config import default_dtype, prepare_device
from exmc_tpu_torch.dists.composite import Custom

__all__ = ["forward_logp", "hmm_dist", "posterior_state_probs", "viterbi"]


def _log_matmul(a, b):
    """(..., K, K) log-space product: logsumexp_k a[i, k] + b[k, j]."""
    return torch.logsumexp(a.unsqueeze(-1) + b.unsqueeze(-3), dim=-2)


def forward_logp(log_obs, log_trans, log_init):
    """log p(y_1:T | theta): ``log_obs`` (..., T, K) per-state emission
    log-densities, ``log_trans`` (..., K, K) rows = from-state,
    ``log_init`` (..., K). Leading axes batch."""
    alpha0 = log_init + log_obs[..., 0, :]
    if log_obs.shape[-2] == 1:
        return torch.logsumexp(alpha0, dim=-1)
    m = log_trans.unsqueeze(-3) + log_obs[..., 1:, None, :]   # (..., T-1, K, K)
    while m.shape[-3] > 1:
        n = m.shape[-3]
        paired = _log_matmul(m[..., 0:n - 1:2, :, :], m[..., 1:n:2, :, :])
        m = torch.cat([paired, m[..., n - 1:, :, :]], dim=-3) if n % 2 else paired
    alpha = torch.logsumexp(alpha0.unsqueeze(-1) + m[..., 0, :, :], dim=-2)
    return torch.logsumexp(alpha, dim=-1)


def _log_obs_matrix(emission_logpdf, y, params, K):
    """(T, K) emission log-densities: state k's column is
    ``emission_logpdf(y, k, params)``."""
    return torch.stack([emission_logpdf(y, k, params) for k in range(K)], dim=-1)


def _stationary(trans, K):
    """The stationary distribution of (..., K, K) transition matrices by
    32 power-iteration steps."""
    pi = torch.full((*trans.shape[:-2], 1, K), 1.0 / K, dtype=trans.dtype,
                    device=trans.device)
    for _ in range(32):
        pi = pi @ trans
    pi = pi.squeeze(-2)
    return pi / torch.sum(pi, dim=-1, keepdim=True)


def _log_trans_init(params, K, stationary_init):
    """(log_trans, log_init) from ``params``' (..., K, K) ``trans`` and
    (..., K) ``init`` (uniform when absent and not stationary)."""
    trans = params["trans"]
    log_trans = torch.log(torch.clamp(trans, 1e-30, 1.0))
    if stationary_init:
        init = _stationary(trans, K)
    elif "init" in params:
        init = params["init"]
    else:
        init = torch.full((K,), 1.0 / K, dtype=trans.dtype, device=trans.device)
    return log_trans, torch.log(torch.clamp(init, 1e-30, 1.0))


def hmm_dist(emission_logpdf, K, *, stationary_init=False):
    """A ``Custom`` distribution whose value is the WHOLE observed
    sequence. ``params`` carry ``trans`` (K, K row-stochastic; rows may
    be sampled simplexes) and, unless ``stationary_init``, ``init`` (K,
    simplex); the rest go to the emission.

    ``emission_logpdf(y, k, params) -> (T,)``: the state-k emission
    log-density of each observation, for one parameter point (k is a
    Python int). ``stationary_init=True`` uses the transition matrix's
    stationary distribution (32 power-iteration steps, differentiable)
    instead of a sampled ``init``."""
    from exmc_tpu_torch.compiler import _per_point

    def logpdf(x, params):
        if not stationary_init and "init" not in params:
            raise ValueError("hmm_dist: params need 'init' unless stationary_init=True")
        keys = tuple(sorted(params))

        def log_obs(xv, *vals):
            return _log_obs_matrix(emission_logpdf, xv, dict(zip(keys, vals)), K)

        lo = _per_point("hmm_dist", log_obs, [x, *(params[k] for k in keys)])
        # the transition pieces and the forward pass act on the batch
        return forward_logp(lo, *_log_trans_init(params, K, stationary_init))

    return Custom(logpdf, align=False)


def _prep(emission_logpdf, y, params, K, stationary_init, device):
    ref = next((v for v in params.values() if isinstance(v, torch.Tensor)), None)
    dev = ref.device if ref is not None else prepare_device(device)

    def t(v):
        return torch.as_tensor(v, dtype=default_dtype(), device=dev)

    params = {k: t(v) for k, v in params.items()}
    return (_log_obs_matrix(emission_logpdf, t(y), params, K),
            *_log_trans_init(params, K, stationary_init))


def posterior_state_probs(emission_logpdf, y, params, K, stationary_init=False,
                          device=None):
    """Forward-backward smoothing gamma (T, K): p(s_t = k | y, theta)
    for ONE parameter draw (tensors, or arrays put on ``device``,
    default ``"cuda"``). Pass the ``stationary_init`` the model's
    hmm_dist used."""
    log_obs, log_trans, log_init = _prep(emission_logpdf, y, params, K,
                                         stationary_init, device)
    T = log_obs.shape[0]
    alphas = [log_init + log_obs[0]]
    for t in range(1, T):
        alphas.append(log_obs[t] + torch.logsumexp(alphas[-1][:, None] + log_trans, dim=0))
    betas = [torch.zeros(K, dtype=log_obs.dtype, device=log_obs.device)]
    for t in range(T - 1, 0, -1):
        betas.append(torch.logsumexp(log_trans + (log_obs[t] + betas[-1])[None, :], dim=1))
    lg = torch.stack(alphas) + torch.stack(betas[::-1])
    return torch.exp(lg - torch.logsumexp(lg, dim=1, keepdim=True))


def viterbi(emission_logpdf, y, params, K, stationary_init=False, device=None):
    """MAP state path (T,) int32 for ONE parameter draw. Match
    ``stationary_init`` to the model's hmm_dist."""
    log_obs, log_trans, log_init = _prep(emission_logpdf, y, params, K,
                                         stationary_init, device)
    delta = log_init + log_obs[0]
    backs = []
    for t in range(1, log_obs.shape[0]):
        scores = delta[:, None] + log_trans          # (from, to)
        backs.append(torch.argmax(scores, dim=0))
        delta = log_obs[t] + torch.max(scores, dim=0).values
    state = torch.argmax(delta)
    path = [state]
    for back in reversed(backs):
        state = back[state]
        path.append(state)
    return torch.stack(path[::-1]).to(torch.int32)
