"""Sequential Monte Carlo with tempering, on the compiled log-density
(``exmc_tpu/smc.py``).

The particles are one (N, d) batch. Each stage bisects the tempering
increment so that the incremental weights keep an effective sample size
of ``ess_threshold * N`` (50 fixed bisection steps, tensor code with no
host read inside), resamples systematically (``torch.searchsorted``) and
mutates by ``num_mh_steps`` random-walk Metropolis steps with the
per-coordinate proposal scale 2.38 / sqrt(d) * std(particles). The host
reads the increment and the tempered terms once per stage, and
accumulates the evidence in float64 there. Only log-density values are
needed: the model's batched ``logp`` runs under ``torch.no_grad``.

As in the JAX package, ``tempering="full"`` tempers the whole
log-density from an N(0, I) start (the reference's behaviour; no
evidence), and ``tempering="likelihood"`` tempers the observation terms
only, from prior draws, which telescopes to the marginal likelihood.

Randomness: the start normals (N, d), and per stage one resampling
uniform and per MH step the proposal normals (N, d) and accept uniforms
(N,), from one ``torch.Generator`` seeded from ``seed``. The stage
functions (``_find_delta``, ``_systematic_resample``, ``_mutate``) take
their draws as arguments, so that tests can feed them JAX's.
"""

import warnings

import numpy as np
import torch

from exmc_tpu_torch.compiler import (
    CompiledModel,
    compile_logp,
    constrain_flat,
    partial_logp,
)
from exmc_tpu_torch.config import default_dtype

BISECTION_STEPS = 50
PRIOR_SEED_OFFSET = 7919


def _ess_at(delta_beta, lts):
    """ESS of the incremental weights exp(delta_beta * lts)."""
    log_w = delta_beta * lts
    w = torch.exp(log_w - torch.max(log_w))
    return torch.sum(w) ** 2 / torch.sum(w * w)


def _find_delta(lts, beta, target_ess):
    """The tempering increment whose ESS is ``target_ess``, by
    ``BISECTION_STEPS`` bisections of [0, 1 - beta]; at least 1e-6. A
    0-d tensor: nothing here waits for the device."""
    lo = torch.zeros((), dtype=lts.dtype, device=lts.device)
    hi = torch.full((), 1.0 - beta, dtype=lts.dtype, device=lts.device)
    for _ in range(BISECTION_STEPS):
        mid = 0.5 * (lo + hi)
        ok = _ess_at(mid, lts) >= target_ess
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    return torch.clamp_min(lo, 1e-6)


def _systematic_resample(u0, log_w, n):
    """Systematic resampling: one uniform ``u0``, n strata. An index past
    the end (the f32 cumulative sum short of 1) takes the last particle,
    as JAX's clamped gather does."""
    w = torch.exp(log_w - torch.logsumexp(log_w, dim=0))
    cum = torch.cumsum(w, dim=0)
    pts = (u0 + torch.arange(n, dtype=log_w.dtype, device=log_w.device)) / n
    return torch.clamp_max(torch.searchsorted(cum, pts), n - 1)


def _mutate(batch_lt, batch_lp0, particles, lp0s, lts, beta, zs, us):
    """Random-walk MH steps targeting lp0 + beta * lt, one per (z, u) of
    ``zs`` (each (N, d)) and ``us`` (each (N,)); ``batch_lp0`` None is a
    flat base (lp0 = 0). Returns (particles, lp0s, lts, mean accept
    rate) as tensors."""
    d = particles.shape[1]
    scale = 2.38 / np.sqrt(d) * torch.std(particles, dim=0, unbiased=False)
    n_acc = torch.zeros((), dtype=particles.dtype, device=particles.device)
    for z, u in zip(zs, us):
        prop = particles + scale * z
        lts_prop = batch_lt(prop)
        lp0s_prop = batch_lp0(prop) if batch_lp0 is not None else torch.zeros_like(lts_prop)
        log_alpha = (lp0s_prop + beta * lts_prop) - (lp0s + beta * lts)
        accept = torch.log(u) < log_alpha
        particles = torch.where(accept.unsqueeze(-1), prop, particles)
        lts = torch.where(accept, lts_prop, lts)
        lp0s = torch.where(accept, lp0s_prop, lp0s)
        n_acc = n_acc + torch.mean(accept.to(particles.dtype))
    return particles, lp0s, lts, n_acc / len(zs)


def _log_mean_weight(log_w, n):
    """log of the mean incremental weight over the n particles (float64
    on the host; non-finite weights dropped, -inf when none is left)."""
    finite = log_w[np.isfinite(log_w)]
    if not finite.size:
        return -np.inf
    mx = finite.max()
    return mx + np.log(np.exp(finite - mx).sum() / n)


def smc_sample(ir, *, num_particles=1000, ess_threshold=0.5, num_mh_steps=5,
               seed=0, data=None, ncp=True, max_stages=200, tempering="full",
               device=None):
    """Run tempering SMC on ``device`` (default ``"cuda"``). Returns
    (trace, info): a constrained named trace of shape (1, num_particles,
    ...), and info with the beta ladder, the ESS and acceptance history,
    ``num_stages``, ``converged``, the unconstrained particles and, for
    ``tempering="likelihood"``, ``log_evidence`` (None when the ladder
    did not reach 1)."""
    if tempering not in ("full", "likelihood"):
        raise ValueError(f"tempering must be 'full' or 'likelihood', got {tempering!r}")
    model = ir if isinstance(ir, CompiledModel) else compile_logp(ir, ncp=ncp, device=device)
    dt, dev, d = default_dtype(), model.device, model.size
    if data is None:
        data = model.data
    ddata = model.device_data(data)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    if tempering == "likelihood":
        from exmc_tpu_torch.predictive import prior_samples

        prior_fn = partial_logp(model, "prior")
        lik_fn = partial_logp(model, "likelihood")

        def batch_lp0(z):
            return prior_fn(z, ddata)

        def batch_lt(z):
            return lik_fn(z, ddata)

        names = [e.id for e in model.pm.entries]
        if isinstance(ir, CompiledModel):
            # only the rewritten IR exists: draw it as it is (NCP nodes
            # give their z values) and invert the entries' transforms
            # only; unconstrain would invert NCP a second time
            draws = prior_samples(model.ir, num_draws=num_particles,
                                  seed=seed + PRIOR_SEED_OFFSET, data=data,
                                  rewritten=True, device=dev)
            particles = model.pm.to_unconstrained(
                {k: draws[k] for k in names}).to(device=dev, dtype=dt)
        else:
            draws = prior_samples(ir, num_draws=num_particles,
                                  seed=seed + PRIOR_SEED_OFFSET, data=data, device=dev)
            particles = model.unconstrain_batch({k: draws[k] for k in names}).to(dt)
    else:
        def batch_lt(z):
            return model.logp(z, ddata)

        batch_lp0 = None  # the flat beta = 0 base of the reference
        particles = torch.randn(num_particles, d, generator=gen, dtype=dt, device=dev)

    with torch.no_grad():
        lts = batch_lt(particles)
        lp0s = batch_lp0(particles) if batch_lp0 is not None else torch.zeros_like(lts)
        target_ess = ess_threshold * num_particles
        beta, betas, ess_hist, accs = 0.0, [0.0], [], []
        log_evidence, stage = 0.0, 0
        while beta < 1.0 and stage < max_stages:
            lo = _find_delta(lts, beta, target_ess)
            host = torch.cat([lo.reshape(1), lts]).cpu().numpy()  # one read a stage
            delta = min(float(host[0]), 1.0 - beta)
            lts_h = host[1:]
            log_w = delta * lts_h.astype(np.float64)
            w32 = np.exp(np.float32(delta) * lts_h - np.max(np.float32(delta) * lts_h))
            ess_hist.append(float(np.sum(w32) ** 2 / np.sum(w32 * w32)))
            log_evidence += _log_mean_weight(log_w, num_particles)

            u0 = torch.rand((), generator=gen, dtype=dt, device=dev)
            idx = _systematic_resample(
                u0, torch.as_tensor(log_w, dtype=dt, device=dev), num_particles)
            particles, lts, lp0s = particles[idx], lts[idx], lp0s[idx]
            beta = beta + delta
            zs, us = [], []
            for _ in range(num_mh_steps):
                zs.append(torch.randn(num_particles, d, generator=gen, dtype=dt, device=dev))
                us.append(torch.rand(num_particles, generator=gen, dtype=dt, device=dev))
            particles, lp0s, lts, acc = _mutate(
                batch_lt, batch_lp0, particles, lp0s, lts,
                torch.as_tensor(beta, dtype=dt, device=dev), zs, us)
            betas.append(float(beta))
            accs.append(acc)
            stage += 1

    converged = beta >= 1.0
    if not converged:
        warnings.warn(
            f"SMC beta ladder stopped at beta={beta:.4f} after max_stages="
            f"{max_stages}; the returned particles target the TEMPERED "
            "density, not the posterior", stacklevel=2)
    named = constrain_flat(model.ir, model.pm, particles, data)
    trace = {k: v.cpu().numpy()[None] for k, v in named.items()}
    info = {
        "betas": np.asarray(betas),
        "ess": np.asarray(ess_hist),
        "accept_rates": (torch.stack(accs).cpu().numpy() if accs else np.zeros(0)),
        "num_stages": stage,
        "converged": converged,
        "particles_unconstrained": particles.cpu().numpy()[None],
    }
    if tempering == "likelihood":
        info["log_evidence"] = float(log_evidence) if converged else None
    return trace, info
