"""MEADS-style generalized HMC (``exmc_tpu/meads.py``; after Hoffman &
Sountsov 2022): tuning-free and maximally lockstep.

The ensemble is split into K folds, updated one after the other within
an iteration; fold k's preconditioner, step size and damping come from
the current state of fold k-1 (a Metropolis-within-Gibbs stage, so each
stage leaves the target invariant). A stage is exact generalized HMC: a
partial refresh of a standardized persistent momentum, one
preconditioned leapfrog step, a Metropolis accept on the joint, and a
momentum flip on rejection. There is no trajectory loop: one gradient
per chain per iteration, and no host sync in the whole run (every
choice is a ``torch.where``). Each fold stage is a (num_chains /
num_folds, d) batch, so on the card the model's value-and-grad replays
the graph captured for that shape.

``num_warmup`` is discarded burn-in: the kernel never freezes.

The chains form G groups, each an independent ensemble tuned from its
own chains only (``run_groups``; SBC runs one replication a group):
each fold stage of every group is one value-and-grad, and the fold
statistics are ``_fold_tuning`` vmapped over the group axis.
``sample_meads`` is the run of one group.

Randomness: the initial momentum (C, d), and per iteration the refresh
normals (C, d) and the accept uniforms (C,), in chain order (fold-major),
from one ``torch.Generator`` seeded from ``seed``; ``_run`` takes a
carry (the momentum in it) and ``rand(i) -> (xi, un)``, so that tests can
start from the JAX package's state with its draws.
"""

import math
import warnings

import numpy as np
import torch

from exmc_tpu_torch.chees import _halton_base2, _per_group
from exmc_tpu_torch.config import default_dtype
from exmc_tpu_torch.engines_common import (
    KernelCache,
    postprocess_ensemble,
    run_data,
)
from exmc_tpu_torch.nuts.masked import HostSyncs

_EPS_FLOOR = 1e-8
PATHFINDER_SEED_OFFSET = 89
MOMENTUM_SEED_OFFSET = 77_377


def _gram_lambda_max(z):
    """trace(S^2)/trace(S) for the covariance S of the (M, d) rows z, via
    the M x M Gram matrix (one matmul; TF32 is off on the card). Rows are
    scaled by their largest magnitude first, so sum(G*G) cannot overflow
    f32."""
    s = torch.max(torch.abs(z))
    s = torch.where(torch.isfinite(s) & (s > 0), s, torch.ones_like(s))
    zs = z / s
    g = zs @ zs.T
    tr_s = torch.trace(g)
    tr_s2 = torch.sum(g * g)
    lam = tr_s2 / torch.clamp_min(tr_s, _EPS_FLOOR) * (s * s)
    return torch.where(torch.isfinite(lam), lam, torch.full_like(lam, 1.0 / _EPS_FLOOR))


def _fold_tuning(q, grad):
    """Per-fold (sigma, eps, damping) from a fold's (M, d) state: sigma the
    cross-chain sd; eps = 0.5 / sqrt(lambda) of the uncentered second
    moment of preconditioned gradients; damping 1 / sqrt(lambda) of the
    preconditioned positions."""
    m = q.shape[0]
    mean_q = torch.mean(q, dim=0, keepdim=True)
    var_q = torch.mean((q - mean_q) ** 2, dim=0)
    sigma = torch.sqrt(var_q + 1e-12)
    zg = grad * sigma
    zg = torch.where(torch.isfinite(zg), zg, torch.zeros_like(zg))
    lam_g = _gram_lambda_max(zg) / m
    eps = 0.5 / torch.sqrt(torch.clamp_min(lam_g, _EPS_FLOOR))
    zx = (q - mean_q) / sigma
    lam_x = _gram_lambda_max(zx) / m
    gamma = 1.0 / torch.sqrt(torch.clamp_min(lam_x, 1.0))
    return sigma, eps, gamma


class _Kernel:
    """The run's constants: the Halton jitter in [0.5, 1)."""

    def __init__(self, num_warmup, num_samples):
        self.num_warmup, self.num_samples = num_warmup, num_samples
        self.jitter = (0.5 + 0.5 * _halton_base2(num_warmup + num_samples)
                       ).astype(np.float32)


def _step(vag_fold, carry, u_i, xi, un, num_folds, step_size_scale, max_step_size,
          groups):
    """One iteration of ``groups`` independent ensembles as one batch,
    each group's chains consecutive and fold-major within it: the K fold
    stages in turn, fold k's stage for every group at once (one
    (G * C / (G K), d) value-and-grad, ``vag_fold``), each group tuned by
    ``_fold_tuning`` of its own fold k-1. Returns (carry, outputs in
    chain order, eps (G, K), gamma (G, K))."""
    c, d = carry["q"].shape
    g, k_ = groups, num_folds
    per = c // (g * k_)

    def folds(t):
        return list(t.reshape((g, k_, per) + tuple(t.shape[1:])).unbind(1))

    q, logp, grad, u = (folds(carry[n]) for n in ("q", "logp", "grad", "u"))
    xi, un = folds(xi), folds(un)
    acc_f, div_f, en_f, eps_f, gam_f = [], [], [], [], []
    for k in range(k_):
        prev = (k - 1) % k_
        sigma, eps, gamma = _per_group(_fold_tuning, g, q[prev], grad[prev])
        eps = eps * (step_size_scale * u_i)
        if max_step_size is not None:
            eps = torch.clamp_max(eps, max_step_size)
        alpha = torch.exp(-gamma * eps)
        e3, a3, s3 = eps[:, None, None], alpha[:, None, None], sigma[:, None, :]
        # partial refresh of the standardized momentum (N(0, I)-invariant)
        uk = a3 * u[k] + torch.sqrt(1.0 - a3 ** 2) * xi[k]
        joint0 = logp[k] - 0.5 * torch.sum(uk * uk, dim=-1)
        u_half = uk + 0.5 * e3 * s3 * grad[k]
        q1 = q[k] + e3 * s3 * u_half
        logp1, grad1 = vag_fold(q1.reshape(g * per, d))
        logp1, grad1 = logp1.reshape(g, per), grad1.reshape(g, per, d)
        u1 = u_half + 0.5 * e3 * s3 * grad1
        joint1 = logp1 - 0.5 * torch.sum(u1 * u1, dim=-1)
        delta = joint1 - joint0
        # a finite endpoint with a non-finite gradient is rejected: the
        # accepted grad is carried into every later step
        ok = torch.isfinite(delta) & torch.isfinite(grad1).all(-1)
        delta = torch.where(ok, delta, torch.full_like(delta, -math.inf))
        accept_prob = torch.exp(torch.clamp_max(delta, 0.0))
        take = un[k] < accept_prob
        tk = take.unsqueeze(-1)
        q[k] = torch.where(tk, q1, q[k])
        logp[k] = torch.where(take, logp1, logp[k])
        grad[k] = torch.where(tk, grad1, grad[k])
        # momentum flip on rejection (the persistent chain's reversibility)
        u[k] = torch.where(tk, u1, -uk)
        acc_f.append(accept_prob)
        div_f.append(delta < -1000.0)
        en_f.append(-torch.where(take, joint1, joint0))
        eps_f.append(eps)
        gam_f.append(gamma)

    def chains(ts):
        t = torch.stack(ts, dim=1)
        return t.reshape((c,) + tuple(t.shape[3:]))

    carry = dict(q=chains(q), logp=chains(logp), grad=chains(grad), u=chains(u))
    out = dict(q=carry["q"], logp=carry["logp"], accept_prob=chains(acc_f),
               diverging=chains(div_f), energy=chains(en_f))
    return carry, out, torch.stack(eps_f, dim=1), torch.stack(gam_f, dim=1)


def _run(vag_fold, carry, kernel, num_folds, step_size_scale, max_step_size, rand,
         groups=1, on_iter=None, first=0, last=None):
    """Iterations ``first`` .. ``last`` (default: to the end) of burn-in
    and sampling of ``groups`` ensembles from ``carry``; ``rand(i) ->
    (xi, un)``; ``on_iter(i, carry, eps, gamma)`` sees the carry and the
    folds' tuning after each iteration. Returns (carry, outs (C, samples
    run, ...), last eps (G, K), last gamma (G, K))."""
    total = kernel.num_warmup + kernel.num_samples
    last = total if last is None else last
    c, d = carry["q"].shape
    dt, dev = carry["q"].dtype, carry["q"].device
    ns = max(last - max(first, kernel.num_warmup), 0)
    outs = {"q": torch.empty(c, ns, d, dtype=dt, device=dev),
            "logp": torch.empty(c, ns, dtype=dt, device=dev),
            "accept_prob": torch.empty(c, ns, dtype=dt, device=dev),
            "diverging": torch.empty(c, ns, dtype=torch.bool, device=dev),
            "energy": torch.empty(c, ns, dtype=dt, device=dev)}
    eps = gamma = None
    k = 0
    for i in range(first, last):
        xi, un = rand(i)
        carry, out, eps, gamma = _step(vag_fold, carry, float(kernel.jitter[i]), xi, un,
                                       num_folds, step_size_scale, max_step_size, groups)
        if i >= kernel.num_warmup:
            for name in outs:
                outs[name][:, k] = out[name]
            k += 1
        if on_iter is not None:
            on_iter(i, carry, eps, gamma)
    return carry, outs, eps, gamma


def run_groups(model, ddata_chains, ddata_folds, q_inits, groups, num_folds,
               num_warmup, num_samples, seed, step_size_scale=1.0, max_step_size=None,
               rand=None, syncs=None, kernel=None):
    """MEADS on ``groups`` independent ensembles of
    ``q_inits.shape[0] / groups`` chains each, as one batch from
    ``q_inits`` (G * M, d). ``ddata_chains`` and ``ddata_folds`` (a
    ``DeviceData`` or None) carry the data with a leading axis of G * M
    and of G * M / num_folds rows (or 1). Draws come from generators
    seeded from ``seed`` as in ``sample_meads``, or from ``rand(i) ->
    (xi, un)``. Returns (outs, final carry, eps (G, K), gamma (G, K))."""
    from exmc_tpu_torch.nuts.sampler import _find_valid_init

    c, d = q_inits.shape
    dt, dev = default_dtype(), model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q0, logp0, grad0 = _find_valid_init(
        lambda q: model.value_and_grad(q, ddata_chains), q_inits, gen, syncs=syncs)
    mom_gen = torch.Generator(device=dev)
    mom_gen.manual_seed(seed + MOMENTUM_SEED_OFFSET)
    u0 = torch.randn(c, d, generator=mom_gen, dtype=dt, device=dev)
    carry = dict(q=q0, logp=logp0, grad=grad0, u=u0)
    if rand is None:
        def rand(i):
            return (torch.randn(c, d, generator=gen, dtype=dt, device=dev),
                    torch.rand(c, generator=gen, dtype=dt, device=dev))
    kernel = kernel or _Kernel(num_warmup, num_samples)
    carry, outs, eps, gamma = _run(lambda q: model.value_and_grad(q, ddata_folds), carry,
                                   kernel, num_folds, float(step_size_scale),
                                   max_step_size, rand, groups)
    return outs, carry, eps, gamma


_KERNEL_CACHE = KernelCache()


def clear_kernel_cache():
    _KERNEL_CACHE.clear()


def _is_device_error(e):
    """A CUDA or device fault (as opposed to a failure of the fit)."""
    kinds = tuple(k for k in (getattr(torch, "AcceleratorError", None),
                              torch.cuda.OutOfMemoryError) if k is not None)
    return isinstance(e, kinds) or (isinstance(e, RuntimeError) and "CUDA" in str(e))


def _pathfinder_ensemble(model, data, num_chains, seed, gen):
    """Ensemble init from a Pathfinder diag fit in the unconstrained
    space, the spread capped at 1 per coordinate; None (-> overdispersed
    draws) with a warning if the fit fails or is non-finite. A device
    fault is not a failure of the fit and propagates."""
    from exmc_tpu_torch.pathfinder import pathfinder_fit

    try:
        fit = pathfinder_fit(model, num_iters=100, num_draws=2, num_elbo_draws=10,
                             seed=seed + PATHFINDER_SEED_OFFSET, data=data)
    except Exception as e:  # noqa: BLE001 - the fit's failures downgrade the init
        if _is_device_error(e):
            raise
        warnings.warn(
            f"MEADS init='pathfinder' fit failed ({type(e).__name__}: {e}); "
            "falling back to overdispersed inits — expect a slower "
            "self-tuning transient on concentrated posteriors", stacklevel=3)
        return None
    mu, sigma = fit["mu"], fit["sigma"]
    if not (np.all(np.isfinite(mu)) and np.all(np.isfinite(sigma)) and np.all(sigma > 0)):
        warnings.warn("MEADS init='pathfinder' fit returned non-finite moments; "
                      "falling back to overdispersed inits", stacklevel=3)
        return None
    # the fitted mode is usually sound even when the diag fit's sigma
    # blows up: cap the spread at O(1) per unconstrained coordinate
    dt, dev = default_dtype(), model.device
    sigma = torch.as_tensor(np.minimum(sigma, 1.0), dtype=dt, device=dev)
    z = torch.randn(num_chains, mu.shape[0], generator=gen, dtype=dt, device=dev)
    return torch.as_tensor(mu, dtype=dt, device=dev) + sigma * z


def sample_meads(ir, *, num_chains=128, num_folds=4, num_warmup=500,
                 num_samples=1000, seed=0, init="pathfinder", data=None,
                 ncp=True, step_size_scale=1.0, max_step_size=None,
                 return_unconstrained=False, device=None):
    """MEADS-style GHMC over ``num_chains`` chains in ``num_folds`` folds
    on ``device`` (default ``"cuda"``). Returns (trace, stats) like
    ``sample``; stats arrays are (chains, samples); ``step_size`` /
    ``damping`` are the (folds,) tuning of the last iteration.

    ``init``: "pathfinder" (default: the ensemble drawn from a Pathfinder
    fit), "random" (overdispersed per-chain draws) or a dict of named
    values (every chain there, with a 0.01 jitter)."""
    from exmc_tpu_torch.nuts.sampler import CHAIN_SEED_STRIDE, INIT_SEED_OFFSET, _init_position

    if num_chains % num_folds != 0:
        raise ValueError(f"num_chains={num_chains} not divisible by folds={num_folds}")
    if num_folds < 2:
        raise ValueError("MEADS needs >= 2 folds (tuning must come from "
                         "a complementary fold)")
    if num_chains // num_folds < 2:
        raise ValueError("need >= 2 chains per fold for cross-chain "
                         "variance estimates")
    if not (isinstance(init, dict) or init in ("pathfinder", "random", None)):
        raise ValueError(f"unknown init {init!r} (dict | 'pathfinder' | 'random')")
    key = (KernelCache.model_sig(ir, ncp), num_chains, num_folds, num_warmup,
           num_samples, float(step_size_scale), max_step_size)
    model, kernel = _KERNEL_CACHE.get_or_build(
        key, ir, ncp, device, lambda: _Kernel(num_warmup, num_samples))
    d = model.size
    if d == 0:
        return {}, {"note": "model has no free parameters"}
    dt, dev = default_dtype(), model.device
    ddata = run_data(ir, model, data)
    syncs = HostSyncs()
    init_gen = torch.Generator(device=dev)
    init_gen.manual_seed(seed * CHAIN_SEED_STRIDE + INIT_SEED_OFFSET)
    q_inits = None
    if isinstance(init, dict):
        flat0 = model.unconstrain(init).to(dt)
        q_inits = flat0 + 0.01 * torch.randn(num_chains, d, generator=init_gen,
                                              dtype=dt, device=dev)
    elif init == "pathfinder":
        q_inits = _pathfinder_ensemble(model, ddata, num_chains, seed, init_gen)
    if q_inits is None:  # overdispersed per-chain draws
        q_inits = _init_position(init_gen, (num_chains, d), dt, dev)
    outs, _, eps, gamma = run_groups(model, ddata, ddata, q_inits, 1, num_folds,
                                     num_warmup, num_samples, seed, step_size_scale,
                                     max_step_size, syncs=syncs, kernel=kernel)
    extra = {"step_size": eps[0].cpu().numpy() if eps is not None else None,
             "damping": gamma[0].cpu().numpy() if gamma is not None else None,
             "host_syncs": syncs.count}
    return postprocess_ensemble(outs, model, ddata, return_unconstrained, extra)
