"""NUTS sampling orchestrator (``exmc_tpu/nuts/sampler.py``).

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

Run modes, as in the JAX package: ``data=`` (the runtime data channel,
``compiler.py``); ``warm_start=stats`` (a ``FINE_TUNE_ITERS`` step-size
fine-tune on the given metric instead of the warmup); ``shared_warmup``
(chain 0 warms up alone, every chain samples with its step size and
metric); ``run_chunked`` (the same pipeline in segments, with an exact
checkpoint and resume); ``sample_stream`` (a host callback per chunk, or
every k-th draw from the pipeline loop); dict, array and superchain
inits; and a cache of samplers keyed on the IR's signature.
``init="pathfinder"`` starts the chains from draws of a multi-path
Pathfinder fit (``pathfinder.pathfinder_init``). ``sample(engine=...)``
dispatches to the ensemble engines (``chees.py``, ``meads.py``).

Over several ranks (``parallel.sample_chains_sharded``) each rank runs
this pipeline on its own chains: ``NUTSSampler(group=...)`` takes the
pooled Welford merge, the ensemble rescue and the shared warmup's
tuning over every rank's chains, and ``vag_builder`` swaps in the
data-parallel value-and-grad. The tree loop syncs on this rank's chains
only, with no collective.
"""

import functools
import hashlib
import warnings
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from exmc_tpu_torch.compiler import CompiledModel, compile_logp, constrainer
from exmc_tpu_torch.config import default_dtype, np_dtype, prepare_device
from exmc_tpu_torch.dists.base import Distribution
from exmc_tpu_torch.dists.composite import Custom
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
from exmc_tpu_torch.transforms import Transform
from exmc_tpu_torch.utils import profiling

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
# shared warmup: the sampling generator is seeded apart from the
# warmup's, as the JAX package folds 777_000_111 into the chain keys
SHARED_SAMPLING_SEED_OFFSET = 777_000_111

FINE_TUNE_ITERS = 50  # warm-start fine-tune window


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


# where a NUTS run calls the model's value-and-grad (``HostSyncs.counted``
# counts each site's calls): the tree's leapfrog steps, the init search,
# the step-size search, the dead-chain recovery's fresh point, the
# ensemble rescue and the interweave step
VAG_SITES = ("leaf", "init", "eps_search", "recovery", "rescue", "interweave")


def _find_valid_init(vag_fn, q0, generator, max_tries=100, syncs=None, group=None):
    """Redraw each chain's init point until its logp and grad are finite,
    with a radius that shrinks as 2.0 * 0.8^i (floored at 1e-3).

    Under a ``group`` of ranks, ``q0`` is this rank's block of the
    chains: every rank redraws while a chain of any rank is bad, each
    redraw drawing the whole batch and keeping this rank's rows, so that
    ``generator`` stays in step with the one-process run's."""
    syncs = HostSyncs() if syncs is None else syncs
    q = q0
    n = q.shape[0] * (1 if group is None else group.size)
    rows = slice(None) if group is None else group.block(n, "chains")
    logp, grad = vag_fn(q)
    for i in range(max_tries):
        bad = ~(torch.isfinite(logp) & torch.isfinite(grad).all(-1))
        any_bad = bad if group is None else group.psum(bad.sum())[0] > 0
        if not syncs.any(any_bad):
            break
        radius = max(2.0 * 0.8 ** i, 1e-3)
        q_new = _init_position(generator, (n,) + tuple(q.shape[1:]), q.dtype, q.device,
                               radius)[rows]
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
    n_steps_warmup: torch.Tensor  # (C,) int32, leapfrog steps of the warmup iterations


def _pipeline_init(vag_fn, q0, logp0, grad0, metric0, eps0=None,
                   init_search=False, generator=None, syncs=None):
    c, d = q0.shape
    if eps0 is None and init_search:
        # only for schedules with no warmup iterations to host the search
        syncs = HostSyncs() if syncs is None else syncs
        with profiling.span("exmc.eps_search"):
            z = torch.randn(c, d, generator=generator, dtype=q0.dtype, device=q0.device)
            eps0 = find_reasonable_epsilon(syncs.counted(vag_fn, "eps_search"), q0, logp0,
                                           grad0, metric0, z, syncs=syncs)
    eps = torch.full_like(logp0, 1.0) if eps0 is None else eps0
    zeros = torch.zeros(c, dtype=torch.int32, device=q0.device)
    return Carry(q0, logp0, grad0, da_init(eps),
                 welford_init(c, d, q0.dtype, q0.device, dense=metric0.dense),
                 metric0, zeros, zeros, zeros)


def _rescue_reference(q, logp, inv, group=None):
    """(logp of every chain, q and inv of the 75th-percentile chain) over
    the chains of all ranks of ``group`` (None: this process's chains):
    every rank's logp gathered by a zero-padded ``all_reduce``, and the
    reference chain's q and inv summed from its owner (the others add
    zeros). It reads nothing on the host itself; under gloo each
    ``all_reduce`` of CUDA tensors is staged through the host
    (``AxisGroup.host_staged`` counts them)."""
    c = logp.shape[0]
    all_logp = logp if group is None else group.gather_rows(logp)
    n = all_logp.shape[0]
    ref_idx = torch.argsort(all_logp, stable=True)[int(np.ceil(0.75 * (n - 1)))]
    owner = (ref_idx // c) == (0 if group is None else group.index)
    local = torch.remainder(ref_idx, c)
    q_ref = torch.where(owner, q[local], torch.zeros_like(q[0]))
    inv_ref = torch.where(owner, inv[local], torch.zeros_like(inv[0]))
    if group is not None:
        q_ref, inv_ref = group.psum(q_ref, inv_ref)
    return all_logp, all_logp[ref_idx], q_ref, inv_ref


def _rescue(vag_fn, q, logp, grad, metric, rescues, generator, group=None):
    """Warmup ENSEMBLE RESCUE: chains whose logp sits far below the
    75th-percentile chain adopt that chain's position (jittered) and
    metric. The threshold is max(50, 1.5 sqrt(d)) nats; a majority is
    never rescued; with fewer than 5 chains nothing happens. With a
    ``group`` of several ranks the percentile and the majority are taken
    over the chains of all of them."""
    c, d = q.shape
    if c * (1 if group is None else group.size) < 5:
        return q, logp, grad, metric, rescues
    all_logp, ref, q_ref, inv_ref = _rescue_reference(q, logp, metric.inv, group)
    thresh = ref - max(50.0, 1.5 * np.sqrt(d))
    frac = (all_logp < thresh).to(q.dtype).mean()
    bad = (logp < thresh) & (frac <= 0.5)
    noise = torch.randn(c, d, generator=generator, dtype=q.dtype, device=q.device)
    q_new = keep(bad, q_ref + 0.01 * noise, q)
    logp_new, grad_new = vag_fn(q_new)
    inv_new = keep(bad, inv_ref.expand_as(metric.inv), metric.inv)
    return (q_new, logp_new, grad_new, make_metric(inv_new, dense=metric.dense),
            rescues + bad.to(torch.int32))


def _pipeline_segment(vag_fn, carry: Carry, xs, target_accept, max_depth,
                      adapt_mass, pooled=False, rescue=False, generator=None,
                      syncs=None, interweave_fn=None, freeze_mask=None,
                      cond_metric_fn=None, emit_fn=None, emit_every=1,
                      draw_offset=0, group=None):
    """Run the iterations of ``xs`` (see ``_pipeline_xs``) for every
    chain. ``pooled`` merges the Welford moments across all chains at
    each window end; ``rescue`` runs the ensemble rescue at the
    post-window checkpoints. ``interweave_fn`` runs after each
    transition; ``freeze_mask`` (d,) re-zeroes the frozen scales'
    inverse mass at each window end; ``cond_metric_fn(q, inv)`` gives
    the metric of each transition and eps search. ``group`` (an
    ``AxisGroup`` of ranks holding the other chains) takes the pooled
    merge and the rescue over every rank's chains. ``emit_fn(i, q,
    stats)`` receives every ``emit_every``-th post-warmup draw of the
    run, ``i`` counting draws from the run's first (the segment's first
    is draw ``draw_offset``).

    With tracing on (``utils.profiling``) the iterations run in an
    ``exmc.warmup`` and an ``exmc.draws`` span, and their parts in the
    spans ``exmc.rescue``, ``exmc.eps_search``, ``exmc.tree``,
    ``exmc.recovery`` and ``exmc.adapt``.

    Returns (carry, draws (C, S, d), stats {name: (C, S)}) for the S
    post-warmup iterations of the segment."""
    syncs = HostSyncs() if syncs is None else syncs
    vag = {site: syncs.counted(vag_fn, site) for site in VAG_SITES}
    q, logp, grad, da, wf, metric, recoveries, rescues, n_steps_warmup = carry
    c, d = q.shape
    dev, dtype = q.device, q.dtype
    upd, win, caps, in_warm, search, resc, _ = xs
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
    k = 0  # post-warmup iterations of the segment so far
    phase = None  # the open exmc.warmup or exmc.draws span
    for it in range(len(upd)):
        warm = bool(in_warm[it])
        if not warm and syncs.warmup is None:
            syncs.warmup = syncs.count
        name = "exmc.warmup" if warm else "exmc.draws"
        if profiling.TRACING and (phase is None or phase.name != name):
            profiling.end(phase)
            phase = profiling.begin(name)
        if rescue and resc[it]:
            with profiling.span("exmc.rescue"):
                q, logp, grad, metric, rescues = _rescue(
                    vag["rescue"], q, logp, grad, metric, rescues, generator, group)
        # gibbs_scales: the frozen scales' latents get their analytic
        # conditional inverse mass at the current scale values
        metric_t = (metric if cond_metric_fn is None
                    else make_metric(cond_metric_fn(q, metric.inv)))
        if search[it]:
            with profiling.span("exmc.eps_search"):
                z = torch.randn(c, d, generator=generator, dtype=dtype, device=dev)
                da = da_init(find_reasonable_epsilon(vag["eps_search"], q, logp, grad,
                                                     metric_t, z, syncs=syncs))
        eps = torch.exp(da.log_eps) if warm else da_finalize(da)
        with profiling.span("exmc.tree"):
            q, logp, grad, st = nuts_transition(
                vag["leaf"], metric_t, eps, q, logp, grad, max_depth, int(caps[it]),
                generator=generator, syncs=syncs)
        if warm:
            n_steps_warmup = n_steps_warmup + st["n_steps"]
        # dead-chain recovery: a non-finite accepted state re-initializes
        # near the origin during warmup. The fresh point is evaluated on
        # every iteration, as in the JAX pipeline.
        with profiling.span("exmc.recovery"):
            dead = ~(torch.isfinite(logp) & torch.isfinite(q).all(-1))
            q_fresh = _init_position(generator, (c, d), dtype, dev, radius=0.1)
            logp_f, grad_f = vag["recovery"](q_fresh)
            if warm:
                q = keep(dead, q_fresh, q)
                logp = keep(dead, logp_f, logp)
                grad = keep(dead, grad_f, grad)
                recoveries = recoveries + dead.to(torch.int32)
        if interweave_fn is not None:
            logp_pre = logp
            q, iw_acc = interweave_fn(q, generator)
            logp, grad = vag["interweave"](q)
            # the recorded draw is the post-interweave state: shift the
            # energy's potential term with it, so energy + logp stays the
            # kinetic energy
            st = dict(st, energy=st["energy"] - (logp - logp_pre))
        with profiling.span("exmc.adapt"):
            if warm:
                # the dual-averaging signal stays per chain even under
                # pooled mass adaptation
                da = da_update(da, st["accept_prob"], target_accept)
            if adapt_mass:
                # divergent draws are excluded from Welford
                enabled = ~st["diverging"] if upd[it] else torch.zeros_like(st["diverging"])
                wf = welford_update(wf, q, enabled)
                if win[it]:
                    wf_eff = welford_merge_across(wf, group) if pooled else wf
                    inv = welford_finalize(wf_eff, metric.inv)
                    if freeze_mask is not None:
                        # the Gibbs legs move the frozen scales between
                        # transitions; keep them out of the dynamics
                        inv = inv * freeze_mask
                    metric = make_metric(inv, dense=metric.dense)
                    wf = welford_init(c, d, dtype, dev, dense=metric.dense)
        if not warm:
            draws[:, k] = q
            for name in ("depth", "n_steps", "diverging", "accept_prob", "energy"):
                stats[name][:, k] = st[name]
            stats["logp"][:, k] = logp
            stats["step_size"][:, k] = eps
            if interweave_fn is not None:
                stats["iw_accept"][:, k] = iw_acc
            if emit_fn is not None and (draw_offset + k + 1) % emit_every == 0:
                emit_fn(draw_offset + k, q, {n: v[:, k] for n, v in stats.items()})
            k += 1
    profiling.end(phase)
    carry = Carry(q, logp, grad, da, wf, metric, recoveries, rescues, n_steps_warmup)
    return carry, draws, stats


def _flatten(tup, prefix=""):
    """{name: tensor or bool} of a (nested) NamedTuple such as ``Carry``."""
    out = {}
    for name, v in zip(tup._fields, tup):
        if hasattr(v, "_fields"):
            out.update(_flatten(v, f"{prefix}{name}."))
        else:
            out[prefix + name] = v
    return out


def _unflatten(cls, arrays, device, prefix=""):
    """Inverse of ``_flatten`` from host arrays, by the NamedTuple's
    annotations."""
    vals = []
    for name in cls._fields:
        kind = cls.__annotations__[name]
        key = prefix + name
        if hasattr(kind, "_fields"):
            vals.append(_unflatten(kind, arrays, device, key + "."))
        elif kind is bool:
            vals.append(bool(arrays[key]))
        else:
            vals.append(torch.as_tensor(arrays[key], device=device))
    return cls(*vals)


def _run_counts(syncs: HostSyncs, iterations, lik_kernel):
    """``last_run`` of a run whose counts ``syncs`` holds; ``lik_kernel``:
    the run's value-and-grad holds the likelihood kernel."""
    calls = {site: syncs.vag_calls.get(site, 0) for site in VAG_SITES}
    return {"host_syncs": syncs.count,
            "host_syncs_warmup": syncs.count if syncs.warmup is None else syncs.warmup,
            "iterations": iterations,
            "vag_calls": calls,
            "vag_calls_lik_kernel": sum(calls.values()) if lik_kernel else 0}


def _fit_spans(run):
    """``run`` (a sampler method) as one ``exmc.fit`` span; with tracing
    on, the sampler's ``last_run`` then holds the fit's spans by name."""

    @functools.wraps(run)
    def traced(self, *args, **kwargs):
        with profiling.fit_spans() as spans:
            out = run(self, *args, **kwargs)
        if spans:
            self.last_run["spans"] = spans
        return out

    return traced


@dataclass
class _Pipeline:
    """What one run of the per-chain pipeline threads through its
    segments."""

    vag: object
    carry: Carry
    xs: tuple
    num_warmup: int
    generator: torch.Generator
    syncs: HostSyncs
    seg_kw: dict


@dataclass
class NUTSSampler:
    """Reusable sampler over a compiled model. ``last_run`` holds what the
    most recent run counted: its host syncs (``host_syncs``; before its
    first post-warmup iteration, the init search included:
    ``host_syncs_warmup``), its iterations, its value-and-grad calls by
    site (``vag_calls``, keyed by ``VAG_SITES``), those of them whose
    graph holds the Bernoulli-logit GLM kernel
    (``vag_calls_lik_kernel``: all of them where
    ``model.lik_kernel_terms`` names a term, else 0) and, with
    tracing on (``utils.profiling.tracing``), its spans by name
    (``spans``: {name: {"count", "total_s", "self_s"}}). A model with
    counters (``model.counters``, such as a Laplace marginal's) adds each
    one's ``read()`` over the run under its ``name`` (counters of one
    name merged), as ``stats["laplace"]``."""

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
    # data -> vag_fn override: the sp-sharded likelihood's hook
    # (parallel.sharding.make_data_parallel_vag)
    vag_builder: object = None
    # the AxisGroup of ranks holding the run's other chains: the pooled
    # merge, the rescue and the shared warmup's tuning span them
    group: object = None
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
            mask = np.ones(self.model.size, np_dtype())
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
        self._ft_schedule = build_schedule(
            FINE_TUNE_ITERS, self.max_tree_depth, init_buffer=FINE_TUNE_ITERS,
            term_buffer=0, early_cap_iters=0)

    def _init_metric(self, c):
        d, dev = self.model.size, self.model.device
        if self.dense_mass:
            return make_metric(
                torch.eye(d, dtype=default_dtype(), device=dev).repeat(c, 1, 1),
                dense=True)
        inv0 = torch.ones(c, d, dtype=default_dtype(), device=dev)
        if self._freeze_mask is not None:
            inv0 = inv0 * self._freeze_mask
        return make_metric(inv0)

    def _resolve_inits(self, init, num_chains, seed, data=None):
        """Per-chain unconstrained inits: ``("superchain", K)`` (K random
        points, each shared by M = num_chains / K consecutive chains, the
        grouping ``nested_rhat`` expects), ``"pathfinder"`` (draws of a
        multi-path Pathfinder fit on the run's ``data``), a named dict of
        constrained values (all chains start there), a (num_chains, d)
        array of unconstrained points, or None (one random point per
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
        if isinstance(init, str):
            if init != "pathfinder":
                raise ValueError(f"unknown init mode {init!r} "
                                 "(expected 'pathfinder' or a named dict)")
            from exmc_tpu_torch.pathfinder import pathfinder_init

            # the fit's seed is drawn from the init generator, as the JAX
            # package draws it from the run's key
            pf_seed = int(torch.randint(0, 2**31 - 1, (), generator=gen, device=dev))
            q = pathfinder_init(self.model, num_chains, seed=pf_seed, data=data)
            return torch.as_tensor(q, dtype=default_dtype(), device=dev)
        if isinstance(init, (np.ndarray, torch.Tensor)):
            q0 = torch.as_tensor(init, dtype=default_dtype(), device=dev)
            if tuple(q0.shape) != (num_chains, d):
                raise ValueError(
                    f"array init must have shape (num_chains, d) = "
                    f"({num_chains}, {d}), got {tuple(q0.shape)}")
            return q0.clone()
        if init is not None:
            flat0 = self.model.unconstrain(init).to(default_dtype())
            return flat0.expand(num_chains, d).clone()
        return _init_position(gen, (num_chains, d), default_dtype(), dev)

    def _reset_counters(self):
        """Zero the model's counters, which the run's stats read at its
        end."""
        for c in self.model.counters:
            c.reset()

    @property
    def _lik_kernel(self):
        """The run's value-and-grad is the model's, with the kernel."""
        return bool(self.model.lik_kernel_terms) and self.vag_builder is None

    def _vag_iw(self, ddata):
        """The run's value-and-grad and interweave step, with its data
        (a ``DeviceData``, or None for the model's own) bound."""
        vag, iw = self.model.value_and_grad, self._iw_fn
        if self.vag_builder is not None:
            vag_fn = self.vag_builder(ddata)
        elif ddata is None:
            vag_fn = vag
        else:
            vag_fn = lambda q: vag(q, ddata)  # noqa: E731
        if iw is None or ddata is None:
            return vag_fn, iw
        return vag_fn, (lambda q, g: iw(q, g, data=ddata))

    @profiling.spanned("exmc.init")
    def _start(self, num_chains, seed, init, warm_start, ddata):
        """Init search and the pipeline's first carry: the warmup of
        ``_schedule``, or with ``warm_start`` the fine-tune of
        ``_ft_schedule`` from its step size and inverse mass."""
        dev = self.model.device
        vag, iw = self._vag_iw(ddata)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        syncs = HostSyncs()
        q_inits = self._resolve_inits(init, num_chains, seed, ddata)
        q0, logp0, grad0 = _find_valid_init(syncs.counted(vag, "init"), q_inits, gen, syncs=syncs)
        seg_kw = dict(interweave_fn=iw, freeze_mask=self._freeze_mask,
                      cond_metric_fn=self._cond_metric_fn)
        if warm_start is None:
            carry = _pipeline_init(vag, q0, logp0, grad0,
                                   self._init_metric(num_chains),
                                   init_search=(self.num_warmup == 0),
                                   generator=gen, syncs=syncs)
            schedule, xs = self._schedule, _pipeline_xs(
                self._schedule, self.num_samples, self.max_tree_depth)
            seg_kw.update(adapt_mass=self.adapt_mass,
                          pooled=self.pooled_adaptation,
                          rescue=self.ensemble_rescue, group=self.group)
        else:
            k = 2 if self.dense_mass else 1
            eps = torch.as_tensor(warm_start["step_size"], dtype=default_dtype(),
                                  device=dev).expand(num_chains).clone()
            inv = torch.as_tensor(warm_start["inv_mass"], dtype=default_dtype(),
                                  device=dev)
            inv = inv.expand((num_chains,) + tuple(inv.shape[-k:])).clone()
            if self._freeze_mask is not None:
                # tuning from a run without gibbs_scales has nonzero
                # entries on the frozen scales: re-freeze them
                inv = inv * self._freeze_mask
            carry = _pipeline_init(vag, q0, logp0, grad0,
                                   make_metric(inv, dense=self.dense_mass),
                                   eps0=eps, generator=gen, syncs=syncs)
            schedule, xs = self._ft_schedule, _pipeline_xs(
                self._ft_schedule, self.num_samples, self.max_tree_depth,
                initial_search=False)
            seg_kw.update(adapt_mass=False, pooled=False, rescue=False)
        return _Pipeline(vag, carry, xs, schedule.num_warmup, gen, syncs, seg_kw)

    def _segment(self, p: _Pipeline, lo, hi, emit=None, every=1):
        """Iterations lo..hi of the pipeline ``p``; returns its draws and
        stats and moves ``p.carry`` on."""
        xs = tuple(a[lo:hi] for a in p.xs)
        p.carry, draws, stats = _pipeline_segment(
            p.vag, p.carry, xs, self.target_accept, self.max_tree_depth,
            generator=p.generator, syncs=p.syncs, emit_fn=emit,
            emit_every=every, draw_offset=max(lo - p.num_warmup, 0), **p.seg_kw)
        return draws, stats

    def _run_shared(self, num_chains, seed, init, ddata, stream_cb, every):
        """Shared warmup: chain 0 runs the warmup alone, then every chain
        samples from its own init with chain 0's step size and metric,
        under a generator seeded apart from the warmup's. Under a
        ``group`` every rank takes the tuning of the first rank's chain
        0."""
        dev = self.model.device
        vag, _ = self._vag_iw(ddata)
        syncs = HostSyncs()
        with profiling.span("exmc.init"):
            q_inits = self._resolve_inits(init, num_chains, seed, ddata)
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            q0, logp0, grad0 = _find_valid_init(syncs.counted(vag, "init"), q_inits[:1], gen,
                                              syncs=syncs)
            carry = _pipeline_init(vag, q0, logp0, grad0, self._init_metric(1),
                                   init_search=(self.num_warmup == 0),
                                   generator=gen, syncs=syncs)
        carry, _, _ = _pipeline_segment(
            vag, carry, _pipeline_xs(self._schedule, 0, self.max_tree_depth),
            self.target_accept, self.max_tree_depth, self.adapt_mass,
            generator=gen, syncs=syncs)
        eps, inv = da_finalize(carry.da), carry.metric.inv
        if self.group is not None:
            eps, inv = self.group.broadcast(eps), self.group.broadcast(inv)
        eps = eps.expand(num_chains).clone()
        inv = inv.expand((num_chains,) + inv.shape[1:]).clone()
        # chain 0 ran the warmup's steps; the others ran none
        n_steps_warmup = torch.cat([carry.n_steps_warmup,
                                    carry.n_steps_warmup.new_zeros(num_chains - 1)])

        with profiling.span("exmc.init"):
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed + SHARED_SAMPLING_SEED_OFFSET)
            q0, logp0, grad0 = _find_valid_init(syncs.counted(vag, "init"), q_inits, gen, syncs=syncs)
            carry = _pipeline_init(vag, q0, logp0, grad0,
                                   make_metric(inv, dense=self.dense_mass),
                                   eps0=eps, generator=gen, syncs=syncs)
        carry = carry._replace(n_steps_warmup=n_steps_warmup)
        p = _Pipeline(vag, carry, _pipeline_xs(build_schedule(0), self.num_samples,
                                               self.max_tree_depth),
                      0, gen, syncs, dict(adapt_mass=False))
        draws, stats = self._segment(p, 0, self.num_samples,
                                     self._emitter(stream_cb, ddata, syncs), every)
        return p, draws, stats

    def _emitter(self, callback, ddata, syncs):
        """The pipeline's ``emit_fn`` for a host ``callback(i, point,
        stats)``: the draw is constrained on the device, then copied to
        the host at once (one sync, counted)."""
        if callback is None:
            return None
        constrain = constrainer(self.model.ir, self.model.pm, self.model.device,
                                self.model.data if ddata is None else ddata)
        names = [e.id for e in self.model.pm.entries]

        def emit(i, q, stats):
            vals = {**constrain(q), **stats}
            host = {k: v.to("cpu", non_blocking=True) for k, v in vals.items()}
            token = profiling.leaf_begin("exmc.sync") if profiling.TRACING else None
            if q.device.type == "cuda":
                torch.cuda.current_stream(q.device).synchronize()
            if token is not None:
                profiling.leaf_end("exmc.sync", token)
            syncs.count += 1
            host = {k: v.numpy() for k, v in host.items()}
            callback(i, {k: host[k] for k in names}, {k: host[k] for k in stats})

        return emit

    @_fit_spans
    def run(self, num_chains=1, seed=0, init=None, warm_start=None, data=None,
            return_unconstrained=False, stream_cb=None, stream_every=1):
        """Warmup + sampling of ``num_chains`` chains. Returns (trace,
        stats): trace arrays are (chains, samples, *shape) constrained
        numpy values; stats has the JAX package's keys and shapes.

        ``data`` replaces the model's own data for this run;
        ``warm_start`` ({"step_size", "inv_mass"}, e.g. a previous run's
        stats) replaces the warmup by a ``FINE_TUNE_ITERS`` step-size
        fine-tune on that metric. ``stream_cb(i, point, stats)`` receives
        every ``stream_every``-th draw as it is made: (num_chains, ...)
        constrained values and (num_chains,) stats."""
        if self.model.size == 0:
            return {}, {"note": "model has no free parameters"}
        self._reset_counters()
        ddata = None if data is None else self.model.device_data(data)
        shared = self.shared_warmup and warm_start is None
        if shared:
            p, draws, st = self._run_shared(num_chains, seed, init, ddata,
                                            stream_cb, stream_every)
        else:
            p = self._start(num_chains, seed, init, warm_start, ddata)
            draws, st = self._segment(p, 0, len(p.xs[0]),
                                      self._emitter(stream_cb, ddata, p.syncs),
                                      stream_every)
        # a shared warmup's iterations ran on chain 0 before p's
        self.last_run = _run_counts(p.syncs, len(p.xs[0]) + (self.num_warmup if shared else 0),
                                    self._lik_kernel)
        return self._finish(p.carry, draws, st, ddata, return_unconstrained)

    @_fit_spans
    def run_chunked(self, num_chains=1, chunk_iters=200, seed=0, init=None,
                    data=None, warm_start=None, return_unconstrained=False,
                    progress=False, callback=None, checkpoint_path=None,
                    resume_from=None):
        """The pipeline of ``run`` in segments of ``chunk_iters``
        iterations; on one device the draws and stats equal ``run``'s bit
        for bit.

        ``callback(start_index, trace_chunk, stats_chunk)`` runs after
        each chunk that holds post-warmup draws. ``checkpoint_path``: after
        every chunk (and its callback), the whole state is saved there —
        the carry, the generator's state, the host-sync count and the
        draws and stats so far — and ``resume_from`` continues such a
        checkpoint to the same result as the uninterrupted run."""
        if self.shared_warmup:
            raise ValueError("run_chunked runs the per-chain pipeline; "
                             "shared_warmup=True runs through run()")
        if self.model.size == 0:
            return {}, {"note": "model has no free parameters"}
        self._reset_counters()
        ddata = None if data is None else self.model.device_data(data)
        dev = self.model.device
        if resume_from is None:
            p = self._start(num_chains, seed, init, warm_start, ddata)
            done, draws_parts, stats_parts = 0, [], []
        else:
            # the pipeline's structure (xs, options) from a start whose
            # carry, generator and counts the checkpoint then replaces. A
            # checkpoint written before the run counted warmup's steps
            # and the value-and-grad calls has neither: those counts
            # start at the resume, and warmup's host syncs at the first
            # post-warmup iteration from there
            with np.load(resume_from) as z:
                arrays = {k: z[k] for k in z.files}
            p = self._start(num_chains, seed, None, warm_start, ddata)
            carry = {k[6:]: v for k, v in arrays.items() if k.startswith("carry.")}
            carry.setdefault("n_steps_warmup", np.zeros(num_chains, np.int32))
            p.carry = _unflatten(Carry, carry, dev)
            p.generator.set_state(torch.as_tensor(arrays["generator"]))
            p.syncs.count = int(arrays["host_syncs"])
            warmup = int(arrays.get("host_syncs_warmup", -1))
            p.syncs.warmup = None if warmup < 0 else warmup
            p.syncs.vag_calls = {k: int(arrays.get(f"vag_calls.{k}", 0)) for k in VAG_SITES}
            done = int(arrays["done"])
            draws_parts = [torch.as_tensor(arrays["draws"], device=dev)]
            stats_parts = [{k[5:]: torch.as_tensor(v, device=dev)
                            for k, v in arrays.items() if k.startswith("stat.")}]
        total = len(p.xs[0])
        while done < total:
            end = min(done + chunk_iters, total)
            draws, stats = self._segment(p, done, end)
            draws_parts.append(draws)
            stats_parts.append(stats)
            if callback is not None and draws.shape[1] > 0:
                cb_stats = {k: v.cpu().numpy() for k, v in stats.items()}
                callback(max(done - p.num_warmup, 0),
                         draws.cpu().numpy() if return_unconstrained
                         else self.constrain_trace(draws, ddata), cb_stats)
            done = end
            if checkpoint_path is not None:
                self._save_chunk_state(checkpoint_path, p, done, draws_parts,
                                       stats_parts)
            if progress:
                print(f"  chunk {done}/{total}", flush=True)
        draws = torch.cat(draws_parts, dim=1)
        stats = {k: torch.cat([s[k] for s in stats_parts], dim=1)
                 for k in stats_parts[0]}
        self.last_run = _run_counts(p.syncs, total, self._lik_kernel)
        return self._finish(p.carry, draws, stats, ddata, return_unconstrained)

    @staticmethod
    def _save_chunk_state(path, p: _Pipeline, done, draws_parts, stats_parts):
        """The carry, the generator's state, the run's counts (host syncs,
        value-and-grad calls), the progress index and the draws and stats
        so far, in one .npz."""
        payload = {f"carry.{k}": (v.cpu().numpy() if torch.is_tensor(v)
                                  else np.asarray(v))
                   for k, v in _flatten(p.carry).items()}
        payload["generator"] = p.generator.get_state().numpy()
        payload["host_syncs"] = np.asarray(p.syncs.count)
        payload["host_syncs_warmup"] = np.asarray(
            -1 if p.syncs.warmup is None else p.syncs.warmup)
        for k in VAG_SITES:
            payload[f"vag_calls.{k}"] = np.asarray(p.syncs.vag_calls.get(k, 0))
        payload["done"] = np.asarray(done)
        payload["draws"] = torch.cat(draws_parts, dim=1).cpu().numpy()
        for k in stats_parts[0]:
            payload[f"stat.{k}"] = torch.cat([s[k] for s in stats_parts],
                                             dim=1).cpu().numpy()
        with open(path, "wb") as f:
            np.savez(f, **payload)

    @profiling.spanned("exmc.finish")
    def _finish(self, carry, draws, st, ddata, return_unconstrained):
        """The run's (trace or draws, stats) on the host; the run's counts
        come from ``last_run``."""
        stats = {k: v.cpu().numpy() for k, v in st.items()}
        stats["step_size"] = da_finalize(carry.da).cpu().numpy()
        stats["inv_mass"] = carry.metric.inv.cpu().numpy()
        stats["recoveries"] = carry.recoveries.cpu().numpy()
        stats["rescues"] = carry.rescues.cpu().numpy()
        stats["n_steps_warmup"] = carry.n_steps_warmup.cpu().numpy()
        stats["divergences"] = stats["diverging"].sum(axis=-1)
        stats["host_syncs"] = self.last_run["host_syncs"]
        stats["vag_calls"] = self.last_run["vag_calls"]
        stats["vag_calls_lik_kernel"] = self.last_run["vag_calls_lik_kernel"]
        for name in dict.fromkeys(c.name for c in self.model.counters):
            group = [c for c in self.model.counters if c.name == name]
            stats[name] = group[0].read(*group[1:])
        _warn_if_rescued(stats["rescues"])
        if return_unconstrained:
            return draws.cpu().numpy(), stats
        return self.constrain_trace(draws, ddata), stats

    def constrain_trace(self, draws, data=None):
        """(chains, samples, d) unconstrained -> named constrained trace
        of (chains, samples, *shape) numpy arrays; ``data`` (None: the
        model's own) feeds refs to the data channel."""
        draws = torch.as_tensor(draws, dtype=default_dtype(), device=self.model.device)
        c, s, d = draws.shape
        out = constrainer(self.model.ir, self.model.pm, self.model.device,
                          self.model.data if data is None else data)(
            draws.reshape(c * s, d))
        return {k: v.reshape((c, s) + tuple(v.shape[1:])).cpu().numpy()
                for k, v in out.items()}


# ---------------------------------------------------------------------------
# Sampler cache: repeated sample() calls on a structurally identical model
# reuse the compiled sampler (its model and CUDA graphs) instead of
# compiling again.
# ---------------------------------------------------------------------------

_SAMPLER_CACHE = OrderedDict()
_SAMPLER_CACHE_MAX = 8


def clear_sampler_cache():
    _SAMPLER_CACHE.clear()


def _hash_obj(h, x, state):
    """Feed one IR op component into the hash: arrays and tensors by
    value, registered dists by name, transforms by name and bounds.
    Custom dists and callables (torch code) hash by identity, which
    marks the signature ``state["stable"] = False``: it holds within one
    process only (the cache holds the IR, so the identity is not
    reused while the entry lives)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):
        h.update(b"a")
        h.update(str((x.shape, str(x.dtype))).encode())
        h.update(np.ascontiguousarray(x).tobytes())
    elif isinstance(x, (list, tuple)):
        h.update(b"l")
        for e in x:
            _hash_obj(h, e, state)
    elif isinstance(x, dict):
        h.update(b"d")
        for k in sorted(x, key=repr):
            _hash_obj(h, k, state)
            _hash_obj(h, x[k], state)
    elif isinstance(x, Distribution) and not isinstance(x, Custom):
        h.update(f"dist:{x.name}".encode())
    elif isinstance(x, Transform):
        h.update(f"tf:{x.name}".encode())
        _hash_obj(h, dict(vars(x)), state)
    elif callable(x) or isinstance(x, Custom):
        h.update(f"id{id(x)}".encode())
        state["stable"] = False
    else:
        r = repr(x)
        if " at 0x" in r:  # default object repr: address = identity
            state["stable"] = False
        h.update(r.encode())


def _data_leaves(data):
    if data is None:
        return []
    if isinstance(data, dict):
        return [(k, np.asarray(data[k])) for k in sorted(data)]
    return [(None, np.asarray(data))]


def ir_fingerprint(ir):
    """(signature, stable): structural + constant signature of an IR.
    Two IRs with the same signature compile to the same model: node
    structure, dist names, constant params and inline obs values hash by
    value; ``Builder.data`` by its keys, shapes and dtypes only (its
    values reach a run through the data channel). ``stable`` is False
    when a component (a Custom dist, a torch callable) hashed by object
    identity."""
    h = hashlib.sha256()
    state = {"stable": True}
    for nid in sorted(ir.nodes):
        node = ir.nodes[nid]
        h.update(nid.encode())
        _hash_obj(h, node.op, state)
        _hash_obj(h, node.deps, state)
        _hash_obj(h, node.shape, state)
    for k, arr in _data_leaves(ir.data):
        h.update(f"data{k}{arr.shape}{arr.dtype}".encode())
    return h.hexdigest(), state["stable"]


def ir_signature(ir) -> str:
    """The signature half of :func:`ir_fingerprint`."""
    return ir_fingerprint(ir)[0]


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
    """A sampler over a compiled model, or over an IR through the LRU
    cache keyed on (signature, ncp, options, device, dtype)."""
    unknown = set(opts) - set(_SAMPLER_OPT_KEYS)
    if unknown:
        raise TypeError(f"unknown sampler options: {sorted(unknown)}")
    if isinstance(ir_or_model, CompiledModel):
        return NUTSSampler(model=ir_or_model, **opts)
    dev = prepare_device(device)
    key = (ir_signature(ir_or_model), bool(ncp), tuple(sorted(opts.items())), str(dev),
           str(default_dtype()))
    hit = _SAMPLER_CACHE.get(key)
    if hit is not None:
        _SAMPLER_CACHE.move_to_end(key)
        return hit
    sampler = NUTSSampler(model=compile_logp(ir_or_model, ncp=ncp, device=dev),
                          **opts)
    _SAMPLER_CACHE[key] = sampler
    while len(_SAMPLER_CACHE) > _SAMPLER_CACHE_MAX:
        _SAMPLER_CACHE.popitem(last=False)
    return sampler


def sample(ir, *, num_chains=1, seed=0, init=None, warm_start=None, data=None,
           ncp=True, device=None, return_unconstrained=False, engine="nuts",
           **opts):
    """Multi-chain NUTS on ``device`` (default ``"cuda"``). Returns
    (trace, stats); trace arrays are (chains, samples, *shape).

    A sampler compiled for a structurally identical IR is reused (the
    cache); this IR's own ``Builder.data`` then rides the data channel,
    so a cached sampler samples this IR's observations.

    ``engine`` dispatches behind the same entry point: "nuts" (default),
    "chees" / "snaper" (lockstep many-chain HMC; the other options go to
    :func:`exmc_tpu_torch.chees.sample_chees`) or "meads" (self-tuning
    GHMC, :func:`exmc_tpu_torch.meads.sample_meads`). These take dict
    inits only and no warm start, and run 64 (ChEES/SNAPER) or 128
    (MEADS) chains when ``num_chains`` is left at 1.

    NOTE on ``ensemble_rescue`` (default True, >= 5 chains): during
    warmup, chains whose logp sits >= max(50, 1.5*sqrt(d)) nats below
    the 75th-percentile chain are teleported onto it at window ends;
    pass ``ensemble_rescue=False`` when hunting multimodality."""
    if engine in ("chees", "snaper"):
        from exmc_tpu_torch.chees import sample_chees

        if init is not None and not isinstance(init, dict):
            raise ValueError(f"engine={engine!r} supports only dict inits")
        if warm_start is not None:
            raise ValueError(f"engine={engine!r} has no warm_start")
        return sample_chees(
            ir, num_chains=(64 if num_chains == 1 else num_chains), seed=seed,
            init=init, data=data, ncp=ncp, device=device,
            return_unconstrained=return_unconstrained, criterion=engine, **opts)
    if engine == "meads":
        from exmc_tpu_torch.meads import sample_meads

        if warm_start is not None:
            raise ValueError("engine='meads' has no warm_start")
        return sample_meads(
            ir, num_chains=(128 if num_chains == 1 else num_chains), seed=seed,
            data=data, ncp=ncp, device=device,
            return_unconstrained=return_unconstrained,
            **({"init": init} if init is not None else {}), **opts)
    if engine != "nuts":
        raise ValueError(f"unknown engine {engine!r} (nuts|chees|snaper|meads)")
    sampler = _make_sampler(ir, ncp=ncp, device=device, **opts)
    if data is None and not isinstance(ir, CompiledModel):
        data = ir.data
    return sampler.run(num_chains=num_chains, seed=seed, init=init,
                       warm_start=warm_start, data=data,
                       return_unconstrained=return_unconstrained)


def sample_chains(ir, num_chains=4, **kwargs):
    """Multi-chain NUTS: ``sample`` with four chains by default."""
    return sample(ir, num_chains=num_chains, **kwargs)


def sample_stream(ir, callback, *, num_chains=1, chunk_size=100, seed=0,
                  init=None, data=None, ncp=True, device=None, every=None,
                  mechanism="chunked", **opts):
    """Streaming sampling. Returns the full (trace, stats) like
    ``sample``.

    * default (``every=None``): ``run_chunked`` in chunks of
      ``chunk_size`` iterations, with ``callback(start_index,
      constrained_chunk, stats_chunk)`` after each chunk that holds
      post-warmup draws.
    * ``every=k``: ``callback(draw_index, constrained_point, stats)`` for
      every k-th post-warmup draw, with the (num_chains, ...) batch of
      that draw. ``mechanism`` says when it is called:

      - ``"chunked"`` (default): ``run_chunked`` in chunks of
        ``max(k, 25)`` iterations; after each chunk, the callback sees
        each of its k-th draws;
      - ``"io_callback"``: from the pipeline loop, as each k-th draw is
        made (the JAX package's ``io_callback``); it costs one copy to
        the host per call and no other sync.

      Both give the callback the same draws, and the run's result is
      the same."""
    if data is None and not isinstance(ir, CompiledModel):
        data = ir.data
    if every is None:
        sampler = _make_sampler(ir, ncp=ncp, device=device, **opts)
        return sampler.run_chunked(num_chains=num_chains, chunk_iters=chunk_size,
                                   seed=seed, init=init, data=data,
                                   callback=callback)
    if not (isinstance(every, int) and every >= 1):
        raise ValueError(f"every must be a positive int, got {every!r}")
    if mechanism not in ("chunked", "io_callback"):
        raise ValueError(f"mechanism must be 'chunked' or 'io_callback', "
                         f"got {mechanism!r}")
    sampler = _make_sampler(ir, ncp=ncp, device=device, **opts)
    if mechanism == "io_callback":
        return sampler.run(num_chains=num_chains, seed=seed, init=init,
                           data=data, stream_cb=callback, stream_every=every)

    def chunk_cb(start, trace_chunk, stats_chunk):
        n = next(iter(trace_chunk.values())).shape[1]
        for j in range(n):
            if (start + j + 1) % every == 0:
                callback(start + j, {k: v[:, j] for k, v in trace_chunk.items()},
                         {k: v[:, j] for k, v in stats_chunk.items()})

    return sampler.run_chunked(num_chains=num_chains, chunk_iters=max(every, 25),
                               seed=seed, init=init, data=data, callback=chunk_cb)
