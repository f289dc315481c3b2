"""NUTS sampling orchestrator (``exmc_tpu/nuts/sampler.py:77-114,
184-435,496-1001,1374-1472``).

Where the JAX package vmaps one chain's pipeline (init search, warmup
with adaptation, sampling) into one jitted program, the port runs the
same pipeline eagerly with a leading chain axis: a Python loop over the
iterations, each a batched NUTS transition. Choices the schedule makes
for all chains at once (eps search, rescue, window end, warmup or not)
are host flags and plain ``if``s; what differs per chain is masked.

Randomness: one ``torch.Generator`` per run on the run's device, seeded
from ``seed``, so a chain's draws depend on the batch it runs in (the
JAX package folds a key per chain). Init points come from a second
generator, seeded from ``seed`` and ``CHAIN_SEED_STRIDE``, so they do
not depend on the transitions' draws.

``interweave`` runs one ASIS scale update of every eligible group after
each transition (``nuts/interweave.py``); ``gibbs_scales`` freezes those
scales in the NUTS dynamics (inverse mass 0) and gives the trajectory
the analytic conditional metric of their latents. ``dense_mass`` adapts
a full (d, d) inverse mass per chain (a dense Welford covariance).

Not ported yet (ROADMAP §1 item 9): streaming, ``run_chunked``,
``warm_start``, ``shared_warmup``, pathfinder and dict inits, and the
sampler cache.
"""

import warnings
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from exmc_tpu_torch.compiler import CompiledModel, compile_logp, constrain_flat
from exmc_tpu_torch.config import default_dtype
from exmc_tpu_torch.nuts.interweave import (
    build_conditional_metric,
    build_interweave,
    eligible_groups,
)
from exmc_tpu_torch.nuts.leapfrog import Metric, make_metric
from exmc_tpu_torch.nuts.masked import HostSyncs, keep
from exmc_tpu_torch.nuts.mass_matrix import (
    WelfordState,
    welford_finalize,
    welford_init,
    welford_merge_across,
    welford_update,
)
from exmc_tpu_torch.nuts.step_size import (
    DualAveragingState,
    da_finalize,
    da_init,
    da_update,
    find_reasonable_epsilon,
)
from exmc_tpu_torch.nuts.tree import nuts_transition
from exmc_tpu_torch.nuts.warmup import build_schedule

DEFAULT_OPTS = dict(
    num_warmup=1000,
    num_samples=1000,
    max_tree_depth=10,
    target_accept=0.8,
    seed=0,
)

# chain i seed offset of the JAX package (base + i*7919); here it seeds
# the init-point generator apart from the run's generator
CHAIN_SEED_STRIDE = 7919
INIT_SEED_OFFSET = 10_000_019


def _warn_if_rescued(rescues):
    """Visible notice when warmup ensemble rescue teleported chains."""
    total = int(np.sum(rescues))
    if total > 0:
        warnings.warn(
            f"warmup ensemble rescue teleported chains {total} time(s) "
            "(stats['rescues'] has per-chain counts). If you are probing "
            "for multimodality, rerun with ensemble_rescue=False — "
            "rescue collapses far-separated minority modes during warmup.",
            stacklevel=3,
        )


def _init_position(generator, shape, dtype, device, radius=2.0):
    """Stan-style random init: Uniform(-r, r) in unconstrained space."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return u * (2.0 * radius) - radius


def _find_valid_init(vag_fn, q0, generator, max_tries=100, syncs=None):
    """Redraw each chain's init point until its logp and grad are finite,
    with a radius that shrinks as 2.0 * 0.8^i (floored at 1e-3)."""
    syncs = HostSyncs() if syncs is None else syncs
    q = q0
    logp, grad = vag_fn(q)
    for i in range(max_tries):
        bad = ~(torch.isfinite(logp) & torch.isfinite(grad).all(-1))
        if not syncs.any(bad):
            break
        radius = max(2.0 * 0.8 ** i, 1e-3)
        q_new = _init_position(generator, q.shape, q.dtype, q.device, radius)
        logp_new, grad_new = vag_fn(q_new)
        q = keep(bad, q_new, q)
        logp = keep(bad, logp_new, logp)
        grad = keep(bad, grad_new, grad)
    return q, logp, grad


def _search_flags(schedule, initial_search):
    """bool[num_warmup]: run find_reasonable_epsilon at the START of
    iteration 0 (unless warm-started) and of the iteration after each
    mass-window end."""
    n = schedule.num_warmup
    search = np.zeros(n, dtype=bool)
    if n == 0:
        return search
    search[1:] = schedule.window_end[:-1]
    search[0] = bool(initial_search)
    return search


def _pipeline_xs(schedule, num_samples, max_depth, initial_search=True):
    """Per-iteration host flags of the unified warmup+sampling loop:
    (update_mass, window_end, depth_cap, in_warmup, search, rescue,
    draw_idx)."""
    num_warmup = schedule.num_warmup
    pad = np.zeros(num_samples, dtype=bool)
    draw_idx = np.concatenate(
        [np.zeros(num_warmup, np.int32), np.arange(num_samples, dtype=np.int32)]
    )
    return (
        np.concatenate([schedule.update_mass, pad]),
        np.concatenate([schedule.window_end, pad]),
        np.concatenate(
            [schedule.depth_cap, np.full(num_samples, max_depth, np.int32)]
        ),
        np.concatenate([np.ones(num_warmup, bool), pad]),
        np.concatenate([_search_flags(schedule, initial_search), pad]),
        # ensemble-rescue checkpoints: post-window iterations only
        np.concatenate([_search_flags(schedule, False), pad]),
        draw_idx,
    )


class Carry(NamedTuple):
    q: torch.Tensor            # (C, d)
    logp: torch.Tensor         # (C,)
    grad: torch.Tensor         # (C, d)
    da: DualAveragingState     # fields (C,)
    wf: WelfordState           # per chain
    metric: Metric             # inv (C, d)
    recoveries: torch.Tensor   # (C,) int32
    rescues: torch.Tensor      # (C,) int32


def _pipeline_init(vag_fn, q0, logp0, grad0, metric0, eps0=None,
                   init_search=False, generator=None, syncs=None):
    c, d = q0.shape
    if eps0 is None and init_search:
        # only for schedules with no warmup iterations to host the search
        z = torch.randn(c, d, generator=generator, dtype=q0.dtype, device=q0.device)
        eps0 = find_reasonable_epsilon(vag_fn, q0, logp0, grad0, metric0, z,
                                       syncs=syncs)
    eps = torch.full_like(logp0, 1.0) if eps0 is None else eps0
    zeros = torch.zeros(c, dtype=torch.int32, device=q0.device)
    return Carry(q0, logp0, grad0, da_init(eps),
                 welford_init(c, d, q0.dtype, q0.device, dense=metric0.dense),
                 metric0, zeros, zeros)


def _rescue(vag_fn, q, logp, grad, metric, rescues, generator):
    """Warmup ENSEMBLE RESCUE: chains whose logp sits far below the
    75th-percentile chain adopt that chain's position (jittered) and
    metric. The threshold is max(50, 1.5 sqrt(d)) nats; a majority is
    never rescued; with fewer than 5 chains nothing happens."""
    c, d = q.shape
    if c < 5:
        return q, logp, grad, metric, rescues
    order = torch.argsort(logp, stable=True)
    ref_idx = order[int(np.ceil(0.75 * (c - 1)))]
    ref = logp[ref_idx]
    thresh = ref - max(50.0, 1.5 * np.sqrt(d))
    frac = (logp < thresh).to(q.dtype).mean()
    bad = (logp < thresh) & (frac <= 0.5)
    noise = torch.randn(c, d, generator=generator, dtype=q.dtype, device=q.device)
    q_new = keep(bad, q[ref_idx] + 0.01 * noise, q)
    logp_new, grad_new = vag_fn(q_new)
    inv_new = keep(bad, metric.inv[ref_idx].expand_as(metric.inv), metric.inv)
    return (q_new, logp_new, grad_new, make_metric(inv_new, dense=metric.dense),
            rescues + bad.to(torch.int32))


def _pipeline_segment(vag_fn, carry: Carry, xs, target_accept, max_depth,
                      adapt_mass, pooled=False, rescue=False, generator=None,
                      syncs=None, interweave_fn=None, freeze_mask=None,
                      cond_metric_fn=None):
    """Run the iterations of ``xs`` (see ``_pipeline_xs``) for every
    chain. ``pooled`` merges the Welford moments across all chains at
    each window end; ``rescue`` runs the ensemble rescue at the
    post-window checkpoints. ``interweave_fn`` runs after each
    transition; ``freeze_mask`` (d,) re-zeroes the frozen scales'
    inverse mass at each window end; ``cond_metric_fn(q, inv)`` gives
    the metric of each transition and eps search.

    Returns (carry, draws (C, S, d), stats {name: (C, S)}) for the S
    post-warmup iterations of the segment."""
    syncs = HostSyncs() if syncs is None else syncs
    q, logp, grad, da, wf, metric, recoveries, rescues = carry
    c, d = q.shape
    dev, dtype = q.device, q.dtype
    upd, win, caps, in_warm, search, resc, draw_idx = xs
    n_draws = int((~in_warm).sum())
    draws = torch.empty(c, n_draws, d, dtype=dtype, device=dev)
    stats = {
        "depth": torch.empty(c, n_draws, dtype=torch.int32, device=dev),
        "n_steps": torch.empty(c, n_draws, dtype=torch.int32, device=dev),
        "diverging": torch.empty(c, n_draws, dtype=torch.bool, device=dev),
        "accept_prob": torch.empty(c, n_draws, dtype=dtype, device=dev),
        "energy": torch.empty(c, n_draws, dtype=dtype, device=dev),
        "logp": torch.empty(c, n_draws, dtype=dtype, device=dev),
        "step_size": torch.empty(c, n_draws, dtype=dtype, device=dev),
    }
    if interweave_fn is not None:
        stats["iw_accept"] = torch.empty(c, n_draws, dtype=dtype, device=dev)
    for it in range(len(upd)):
        warm = bool(in_warm[it])
        if rescue and resc[it]:
            q, logp, grad, metric, rescues = _rescue(
                vag_fn, q, logp, grad, metric, rescues, generator)
        # gibbs_scales: the frozen scales' latents get their analytic
        # conditional inverse mass at the current scale values
        metric_t = (metric if cond_metric_fn is None
                    else make_metric(cond_metric_fn(q, metric.inv)))
        if search[it]:
            z = torch.randn(c, d, generator=generator, dtype=dtype, device=dev)
            da = da_init(find_reasonable_epsilon(vag_fn, q, logp, grad,
                                                 metric_t, z, syncs=syncs))
        eps = torch.exp(da.log_eps) if warm else da_finalize(da)
        q, logp, grad, st = nuts_transition(
            vag_fn, metric_t, eps, q, logp, grad, max_depth, int(caps[it]),
            generator=generator, syncs=syncs)
        # dead-chain recovery: a non-finite accepted state re-initializes
        # near the origin during warmup. The fresh point is evaluated on
        # every iteration, as in the JAX pipeline.
        dead = ~(torch.isfinite(logp) & torch.isfinite(q).all(-1))
        q_fresh = _init_position(generator, (c, d), dtype, dev, radius=0.1)
        logp_f, grad_f = vag_fn(q_fresh)
        if warm:
            q = keep(dead, q_fresh, q)
            logp = keep(dead, logp_f, logp)
            grad = keep(dead, grad_f, grad)
            recoveries = recoveries + dead.to(torch.int32)
        if interweave_fn is not None:
            logp_pre = logp
            q, iw_acc = interweave_fn(q, generator)
            logp, grad = vag_fn(q)
            # the recorded draw is the post-interweave state: shift the
            # energy's potential term with it, so energy + logp stays the
            # kinetic energy
            st = dict(st, energy=st["energy"] - (logp - logp_pre))
        if warm:
            # the dual-averaging signal stays per chain even under pooled
            # mass adaptation
            da = da_update(da, st["accept_prob"], target_accept)
        if adapt_mass:
            # divergent draws are excluded from Welford
            enabled = ~st["diverging"] if upd[it] else torch.zeros_like(st["diverging"])
            wf = welford_update(wf, q, enabled)
            if win[it]:
                wf_eff = welford_merge_across(wf) if pooled else wf
                inv = welford_finalize(wf_eff, metric.inv)
                if freeze_mask is not None:
                    # the Gibbs legs move the frozen scales between
                    # transitions; keep them out of the dynamics
                    inv = inv * freeze_mask
                metric = make_metric(inv, dense=metric.dense)
                wf = welford_init(c, d, dtype, dev, dense=metric.dense)
        if not warm:
            k = int(draw_idx[it])
            draws[:, k] = q
            for name in ("depth", "n_steps", "diverging", "accept_prob", "energy"):
                stats[name][:, k] = st[name]
            stats["logp"][:, k] = logp
            stats["step_size"][:, k] = eps
            if interweave_fn is not None:
                stats["iw_accept"][:, k] = iw_acc
    carry = Carry(q, logp, grad, da, wf, metric, recoveries, rescues)
    return carry, draws, stats


@dataclass
class NUTSSampler:
    """Reusable sampler over a compiled model. ``last_run`` holds what the
    most recent ``run`` counted: its host syncs and iterations."""

    model: CompiledModel
    num_warmup: int = DEFAULT_OPTS["num_warmup"]
    num_samples: int = DEFAULT_OPTS["num_samples"]
    max_tree_depth: int = DEFAULT_OPTS["max_tree_depth"]
    target_accept: float = DEFAULT_OPTS["target_accept"]
    dense_mass: bool = False
    shared_warmup: bool = False
    pooled_adaptation: bool = False
    interweave: bool = False
    gibbs_scales: bool = False
    ensemble_rescue: bool = True
    adapt_mass: bool = True
    last_run: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.shared_warmup and self.pooled_adaptation:
            raise ValueError(
                "shared_warmup and pooled_adaptation are mutually exclusive: "
                "shared warmup adapts on chain 0 only, pooling needs all "
                "chains' warmup to run")
        if self.interweave and self.shared_warmup:
            raise ValueError("interweave requires the per-chain pipeline "
                             "(shared_warmup=False)")
        if self.gibbs_scales and not self.interweave:
            raise ValueError(
                "gibbs_scales=True requires interweave=True: frozen "
                "scales move only via the interweave Gibbs legs")
        if self.gibbs_scales and self.dense_mass:
            raise ValueError(
                "gibbs_scales is diag-metric only (freezing is an "
                "inverse-mass zero on the scale coordinate)")
        if self.shared_warmup:
            raise NotImplementedError(
                "shared_warmup=True is not ported yet (ROADMAP §1 item 9)")
        self._iw_fn = None
        if self.interweave:
            self._iw_fn = build_interweave(self.model)
            if self._iw_fn is None:
                raise ValueError(
                    "interweave=True but no eligible NCP scale parameters "
                    "were found (need a scalar free-RV scale referenced "
                    "only as the NCP sigma of Normal/GRW latents; did you "
                    "compile with ncp=False?)")
        self._freeze_mask = None
        self._cond_metric_fn = None
        if self.gibbs_scales:
            mask = np.ones(self.model.size, np.float32)
            frozen = set()
            for g in eligible_groups(self.model):
                kinds = {z[2] for z in g["zs"]}
                # freeze only scales with a sound Gibbs path: an
                # ancillary leg or a pure obs-noise conditional
                if g.get("anc_mode") is None and kinds != {"obs_noise"}:
                    warnings.warn(
                        f"gibbs_scales: scale {g['sigma_id']!r} has no "
                        "ancillary Gibbs leg (observations unavailable "
                        "or non-Normal) — leaving it UNFROZEN; it keeps "
                        "mixing via NUTS + the sufficient interweave "
                        "move", stacklevel=2)
                    continue
                mask[g["offset"]] = 0.0
                frozen.add(g["offset"])
            if frozen:
                self._freeze_mask = torch.as_tensor(mask,
                                                    device=self.model.device)
                self._cond_metric_fn = build_conditional_metric(
                    self.model, frozen_offsets=frozen)
        self._schedule = build_schedule(self.num_warmup, self.max_tree_depth)

    def _resolve_inits(self, init, num_chains, seed):
        """Per-chain unconstrained inits: ``("superchain", K)`` (K random
        points, each shared by M = num_chains / K consecutive chains, the
        grouping ``nested_rhat`` expects) or None (one random point per
        chain)."""
        d, dev = self.model.size, self.model.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed * CHAIN_SEED_STRIDE + INIT_SEED_OFFSET)
        if (isinstance(init, tuple) and len(init) == 2
                and init[0] == "superchain"):
            k = int(init[1])
            if num_chains % k != 0:
                raise ValueError(
                    f"superchain init: num_chains ({num_chains}) not "
                    f"divisible by num_superchains ({k})")
            qs = _init_position(gen, (k, d), default_dtype(), dev)
            return qs.repeat_interleave(num_chains // k, dim=0)
        if init is not None:
            raise NotImplementedError(
                f"init {init!r} is not ported yet; use None or "
                "('superchain', K) (ROADMAP §1 item 9)")
        return _init_position(gen, (num_chains, d), default_dtype(), dev)

    def run(self, num_chains=1, seed=0, init=None, return_unconstrained=False):
        """Warmup + sampling of ``num_chains`` chains. Returns (trace,
        stats): trace arrays are (chains, samples, *shape) constrained
        numpy values; stats has the JAX package's keys and shapes."""
        d = self.model.size
        if d == 0:
            return {}, {"note": "model has no free parameters"}
        dev = self.model.device
        vag = self.model.value_and_grad
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        syncs = HostSyncs()

        q_inits = self._resolve_inits(init, num_chains, seed)
        q0, logp0, grad0 = _find_valid_init(vag, q_inits, gen, syncs=syncs)
        if self.dense_mass:
            metric0 = make_metric(
                torch.eye(d, dtype=q0.dtype, device=dev).repeat(num_chains, 1, 1),
                dense=True)
        else:
            inv0 = torch.ones(num_chains, d, dtype=q0.dtype, device=dev)
            if self._freeze_mask is not None:
                inv0 = inv0 * self._freeze_mask
            metric0 = make_metric(inv0)
        carry = _pipeline_init(vag, q0, logp0, grad0, metric0,
                               init_search=(self.num_warmup == 0),
                               generator=gen, syncs=syncs)
        xs = _pipeline_xs(self._schedule, self.num_samples, self.max_tree_depth)
        carry, draws, st = _pipeline_segment(
            vag, carry, xs, self.target_accept, self.max_tree_depth,
            self.adapt_mass, pooled=self.pooled_adaptation,
            rescue=self.ensemble_rescue, generator=gen, syncs=syncs,
            interweave_fn=self._iw_fn, freeze_mask=self._freeze_mask,
            cond_metric_fn=self._cond_metric_fn)
        self.last_run = {"host_syncs": syncs.count,
                         "iterations": self.num_warmup + self.num_samples}

        stats = {k: v.cpu().numpy() for k, v in st.items()}
        stats["step_size"] = da_finalize(carry.da).cpu().numpy()
        stats["inv_mass"] = carry.metric.inv.cpu().numpy()
        stats["recoveries"] = carry.recoveries.cpu().numpy()
        stats["rescues"] = carry.rescues.cpu().numpy()
        stats["divergences"] = stats["diverging"].sum(axis=-1)
        _warn_if_rescued(stats["rescues"])

        if return_unconstrained:
            return draws.cpu().numpy(), stats
        return self.constrain_trace(draws), stats

    def constrain_trace(self, draws):
        """(chains, samples, d) unconstrained -> named constrained trace
        of (chains, samples, *shape) numpy arrays."""
        draws = torch.as_tensor(draws, dtype=default_dtype(), device=self.model.device)
        c, s, d = draws.shape
        out = constrain_flat(self.model.ir, self.model.pm, draws.reshape(c * s, d),
                             self.model.data)
        return {k: v.reshape((c, s) + tuple(v.shape[1:])).cpu().numpy()
                for k, v in out.items()}


_SAMPLER_OPT_KEYS = (
    "num_warmup",
    "num_samples",
    "max_tree_depth",
    "target_accept",
    "dense_mass",
    "shared_warmup",
    "pooled_adaptation",
    "interweave",
    "gibbs_scales",
    "ensemble_rescue",
    "adapt_mass",
)


def _make_sampler(ir_or_model, ncp=True, device=None, **opts) -> NUTSSampler:
    unknown = set(opts) - set(_SAMPLER_OPT_KEYS)
    if unknown:
        raise TypeError(f"unknown sampler options: {sorted(unknown)}")
    if isinstance(ir_or_model, CompiledModel):
        return NUTSSampler(model=ir_or_model, **opts)
    return NUTSSampler(model=compile_logp(ir_or_model, ncp=ncp, device=device),
                       **opts)


def sample(ir, *, num_chains=1, seed=0, init=None, ncp=True, device=None,
           return_unconstrained=False, **opts):
    """Multi-chain NUTS on ``device`` (default ``"cuda"``). Returns
    (trace, stats); trace arrays are (chains, samples, *shape).

    NOTE on ``ensemble_rescue`` (default True, >= 5 chains): during
    warmup, chains whose logp sits >= max(50, 1.5*sqrt(d)) nats below
    the 75th-percentile chain are teleported onto it at window ends;
    pass ``ensemble_rescue=False`` when hunting multimodality."""
    sampler = _make_sampler(ir, ncp=ncp, device=device, **opts)
    return sampler.run(num_chains=num_chains, seed=seed, init=init,
                       return_unconstrained=return_unconstrained)
