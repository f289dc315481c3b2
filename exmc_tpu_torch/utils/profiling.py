"""Profiling hooks (``exmc_tpu/utils/profiling.py``).

The sampler's per-step stats (depth, n_steps, diverging, accept_prob,
energy, logp) already come out of every run. This module adds:

* ``trace_profile`` — a ``torch.profiler`` trace of a block (the CPU
  and, on a card, CUDA activity), exported as a Chrome trace;
* ``annotate`` / ``annotated_run`` — named spans (``record_function``,
  and an NVTX range on the card), so that the first run, the sampling
  and the diagnostics show as labelled segments of the timeline;
* ``phase_report`` — a host-clock breakdown of a sampler run (model
  build and compile, first run, a second run, constrain, diagnostics),
  with the card synchronized before every clock read.
"""

import contextlib
import os
import tempfile
import time

import torch


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
    """Named span in the profiler trace (``record_function``), and an
    NVTX range when a card is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
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
