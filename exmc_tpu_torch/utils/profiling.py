"""Profiling hooks (``exmc_tpu/utils/profiling.py``).

The sampler's per-step stats (depth, n_steps, diverging, accept_prob,
energy, logp) already come out of every run. This module adds:

* a span recorder, off by default. ``tracing(True)`` switches it on
  (``with tracing(True): ...`` for a block). While it is on, the NUTS
  pipeline's spans (``exmc.fit``, ``exmc.init``, ``exmc.warmup``,
  ``exmc.draws``, ``exmc.finish``, ``exmc.tree``, ``exmc.vag``,
  ``exmc.sync``, ``exmc.adapt``, ``exmc.eps_search``, ``exmc.rescue``,
  ``exmc.recovery``) time themselves on the host clock, and each run's
  spans, reduced by name to ``count``, ``total_s`` and ``self_s`` (the
  time no child span covers), land in ``NUTSSampler.last_run["spans"]``
  (``tracing(True, keep=True)`` also keeps each span's start, end and
  parent). While it is off, a span site costs one test of ``TRACING``. While a ``torch.profiler`` session is active,
  each span also opens a ``record_function`` of its name, so that the
  spans share the device trace's clock;
* ``trace_profile`` — a ``torch.profiler`` trace of a block (the CPU
  and, on a card, CUDA activity), exported as a Chrome trace;
* ``annotate`` / ``annotated_run`` — named spans of the recorder with
  an NVTX range on the card, so that the first run, the sampling and
  the diagnostics show as labelled segments of the timeline;
* ``phase_report`` — a host-clock breakdown of a sampler run (model
  build and compile, first run, a second run, constrain, diagnostics),
  with the card synchronized before every clock read.
"""

import contextlib
import functools
import os
import tempfile
import time
from typing import NamedTuple

import torch

# True while the span recorder is on. A span site on the sampler's path
# tests this flag and does nothing else while it is off.
TRACING = False


class Span(NamedTuple):
    """One closed span: the index of the fit it ran in, its id, its
    parent's id (-1 at the top), its name, and its start and end on the
    host clock (``time.perf_counter_ns``)."""

    run: int
    id: int
    parent: int
    name: str
    start_ns: int
    end_ns: int


class _Open:
    """A span: open from ``begin`` to ``end``, or a ``with`` block."""

    __slots__ = ("id", "parent", "name", "start_ns", "end_ns", "inner_ns", "run", "rf")

    def __init__(self, id, parent, name, start_ns, run, rf):
        self.id, self.parent, self.name = id, parent, name
        self.start_ns, self.inner_ns, self.run, self.rf = start_ns, 0, run, rf

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        end(self)
        return False


_stack = []    # the open recorded spans, innermost last
_keep = False  # keep every closed span for ``last_spans``
_records = []  # with _keep: the closed spans since the latest outermost fit began
_totals = {}   # name -> [count, total_ns, self_ns] of those spans
_next_id = 0
_run = 0       # the latest outermost fit's index
_fits_open = 0
_autograd_profiler = torch.autograd.profiler
_clock_ns = time.perf_counter_ns


class tracing:
    """Switch the span recorder on (``tracing(True)``) or off
    (``tracing(False)``). Used as a context manager, it puts the previous
    state back when the block ends::

        with tracing(True):
            trace, stats = sampler.run(num_chains=64)
        sampler.last_run["spans"]["exmc.tree"]["self_s"]

    The recorder reduces the spans by name as they close. With ``keep``
    it also keeps each closed span (its start, end and parent), which
    ``last_spans`` returns."""

    def __init__(self, on=True, keep=False):
        global TRACING, _keep
        self.previous = TRACING, _keep
        TRACING, _keep = bool(on), bool(on and keep)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global TRACING, _keep
        TRACING, _keep = self.previous


def _close(name, dur, inner):
    if _stack:
        _stack[-1].inner_ns += dur
    t = _totals.get(name)
    if t is None:
        _totals[name] = [1, dur, dur - inner]
    else:
        t[0] += 1
        t[1] += dur
        t[2] += dur - inner


def begin(name, record=True):
    """Open the span ``name``; returns the token that ``end`` takes. With
    ``record`` False only its ``record_function`` opens (while a
    profiler is active), and the recorder keeps nothing of it."""
    global _next_id
    rf = None
    if _autograd_profiler._is_profiler_enabled:
        rf = torch.profiler.record_function(name)
        rf.__enter__()
    if not record:
        return _Open(-1, -1, name, 0, 0, rf)
    span = _Open(_next_id, _stack[-1].id if _stack else -1, name, _clock_ns(), _run, rf)
    _next_id += 1
    _stack.append(span)
    return span


def end(span):
    """Close ``span``, and first every span opened inside it that an
    exception left open. None (tracing was off at ``begin``) does
    nothing."""
    if span is None:
        return
    if not (_stack and _stack[-1] is span) and (
            span.id < 0 or all(s is not span for s in _stack)):
        # a span the recorder does not keep, or one closed already
        if span.rf is not None:
            span.rf.__exit__(None, None, None)
            span.rf = None
        return
    now = _clock_ns()
    while True:
        s = _stack.pop()
        if s.rf is not None:
            s.rf.__exit__(None, None, None)
            s.rf = None
        s.end_ns = now
        _close(s.name, now - s.start_ns, s.inner_ns)
        if _keep:
            _records.append(s)
        if s is span:
            return


def leaf_begin(name):
    """Open the span ``name``, inside which no span opens (a model call,
    a host sync); returns the token that ``leaf_end`` takes. Unless a
    profiler is active or the spans are kept, the token is the start
    time alone: no allocation, no stack."""
    if _keep or _autograd_profiler._is_profiler_enabled:
        return begin(name)
    return _clock_ns()


def leaf_end(name, token):
    """Close the span that ``leaf_begin(name)`` opened. A body that raised
    leaves a leaf unrecorded, or, with a token from ``begin``, open until
    its parent closes."""
    if token.__class__ is int:
        _close(name, _clock_ns() - token, 0)
    else:
        end(token)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name):
    """``with span(name): ...`` records the block while tracing is on; off,
    it is a shared no-op block (no clock read, no allocation)."""
    return begin(name) if TRACING else _NO_SPAN


def spanned(name):
    """Decorator: each call of the function runs in the span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


@contextlib.contextmanager
def fit_spans():
    """The ``exmc.fit`` span of one sampler run. Yields a dict that, once
    the block has ended with tracing on, holds the fit's spans by name:
    {name: {"count", "total_s", "self_s"}}; it stays empty with tracing
    off. A fit run inside another fit counts toward the outer one."""
    global _run, _fits_open
    out = {}
    if not TRACING:
        yield out
        return
    outer = _fits_open == 0
    if outer:
        _run += 1
        _records.clear()
        _totals.clear()
    _fits_open += 1
    token = begin("exmc.fit")
    try:
        yield out
    finally:
        end(token)
        _fits_open -= 1
    if outer:
        out.update({name: {"count": c, "total_s": t / 1e9, "self_s": own / 1e9}
                    for name, (c, t, own) in _totals.items()})


def last_spans():
    """The closed spans (``Span``) since the latest outermost fit began,
    in the order they closed, where the recorder kept them
    (``tracing(True, keep=True)``); else empty."""
    return [Span(s.run, s.id, s.parent, s.name, s.start_ns, s.end_ns) for s in _records]


def _default_logdir():
    return os.path.join(tempfile.gettempdir(), "exmc_tpu_torch_trace")


@contextlib.contextmanager
def trace_profile(logdir=None):
    """Profile a block and write ``trace.json`` (Chrome trace format)
    into ``logdir`` (default: ``exmc_tpu_torch_trace`` in the temporary
    directory)::

        with trace_profile("runs/trace"):
            sample(ir, ...)
    """
    logdir = _default_logdir() if logdir is None else str(logdir)
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name):
    """Named span: a span of the recorder (kept while tracing is on, and
    in the profiler trace whenever a profiler is active), and an NVTX
    range when a card is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    token = begin(name, record=TRACING)
    try:
        yield
    finally:
        end(token)
        if nvtx:
            torch.cuda.nvtx.range_pop()


def annotated_run(sampler, num_chains=4, seed=0, logdir=None, **kwargs):
    """Run a NUTSSampler twice with labelled spans: the first run
    ('exmc:compile+first-run': CUDA graph captures, allocator and
    library start-up) and the second ('exmc:sampling'), which is
    returned. With ``logdir`` the whole is traced (``trace_profile``)."""
    ctx = trace_profile(logdir) if logdir else contextlib.nullcontext()
    with ctx:
        with annotate("exmc:compile+first-run"):
            sampler.run(num_chains=num_chains, seed=seed, **kwargs)
        with annotate("exmc:sampling"):
            out = sampler.run(num_chains=num_chains, seed=seed + 1, **kwargs)
    return out


def _clock(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def phase_report(ir, num_chains=4, seed=0, ncp=True, device=None, **opts):
    """Host-clock wall breakdown: model build and compile, first run
    (CUDA graph captures), second run, trace constrain, diagnostics.
    Returns (report dict, (trace, stats)); the keys are the JAX
    package's."""
    from exmc_tpu_torch.diagnostics import _ess, _rhat
    from exmc_tpu_torch.nuts.sampler import _make_sampler

    report = {}
    t0 = time.perf_counter()
    sampler = _make_sampler(ir, ncp=ncp, device=device, **opts)
    dev = sampler.model.device
    t1 = _clock(dev)
    report["build_and_compile_model_s"] = round(t1 - t0, 3)

    sampler.run(num_chains=num_chains, seed=seed, return_unconstrained=True)
    t0 = _clock(dev)
    report["compile_and_first_run_s"] = round(t0 - t1, 3)

    draws, stats = sampler.run(num_chains=num_chains, seed=seed + 1,
                               return_unconstrained=True)
    t1 = _clock(dev)
    report["pipeline_run_s"] = round(t1 - t0, 3)

    trace = sampler.constrain_trace(draws)
    t0 = _clock(dev)
    report["constrain_s"] = round(t0 - t1, 3)

    for arr in trace.values():
        flat = torch.as_tensor(arr.reshape(arr.shape[0], arr.shape[1], -1)[:, :, 0],
                               device=dev)
        float(_ess(flat))
        float(_rhat(flat))
    t1 = _clock(dev)
    report["diagnostics_s"] = round(t1 - t0, 3)
    report["compile_over_run"] = round(
        report["compile_and_first_run_s"] / max(report["pipeline_run_s"], 1e-9), 1)
    return report, (trace, stats)
