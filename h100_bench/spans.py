"""The program's spans and counters in one cell, beside the benchmark's
result line (which reads the counters but not yet the spans), on the
card:

    python3 h100_bench/spans.py --workload eight_schools.nuts --seed 7 --pairs 2 --profile 1

A stopgap beside the harness, with its own fit loop, profiled fit and
idle labelling: it goes once a benchmark PR has moved ``split`` into
``harness.py`` and ``idle_by_span`` into ``device_trace.py`` and added
the readers of the span metrics.

Set-up as in ``run.py`` (the cell's model built from the seed, its
warm-up fit), then the ``--interleave`` fits, then ``--pairs`` pairs
of whole fits (none with ``--pairs 0``). The two fits of a
pair share a seed, and so their draws and host syncs; one runs with the
program's span recorder off and one with it on, in turns first. With
``--profile 1`` the traced run's profiled fit follows, with the recorder
on, under ``torch.profiler``. Prints one JSON line:

- ``ms_per_sync_off`` / ``ms_per_sync_on``: ``ms_per_sync.nuts`` of the
  fits with the recorder off and on, and ``on_cost`` (%) between them;
  ``leaf_us`` and ``span_us`` (the cost of one empty span, timed here:
  a model call's or a host sync's, which open no span inside them, and
  any other), ``spans_per_sync`` (of each kind) and ``span_cost`` (%):
  the cost the spans should add, their count times their cost over
  ``ms_per_sync_off``, which the host's noise between two fits does not
  blur; with ``--interleave N``, ``interleaved``: N whole fits, run
  first, in which each call of the model's value-and-grad switches the
  recorder on or off by a coin (``interleaved``);
- ``split``: per span name, its self time per host sync (ms) over the
  fits with the recorder on. ``exmc.vag`` (the model's calls issued),
  ``exmc.tree`` (the tree's eager operations issued) and ``exmc.sync``
  (the host's wait at a sync) make ``covered`` (%) of
  ``ms_per_sync_on``; the other spans hold the rest;
- ``warmup_share`` (%): the ``exmc.warmup`` spans over the ``exmc.fit``
  spans;
- ``counters``: the benchmark's readers of ``live_rows.nuts`` and
  ``offtree_vag_per_iter.nuts`` and the host syncs before the draws;
- ``profile``: the profiled fit's ``device_idle`` (%), ``tree_idle`` (%:
  the device idle while the host was inside ``exmc.tree``, its children
  included), ``idle_spans``, the innermost ``exmc.*`` spans under
  which the device idled longest (seconds), and ``runtime_calls``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTSIDE = "outside any span"


def idle_by_span(events, window_s, top=10):
    """The device's idle gaps in kineto ``events``, each labelled by the
    innermost ``exmc.*`` span around its midpoint: {"device_idle",
    "tree_idle" (% of ``window_s``), "idle_spans" ([[name, seconds]],
    the ``top`` longest), "runtime_calls" ([[span, call, seconds]]: the
    host's CUDA runtime calls, such as ``cudaLaunchKernel`` or
    ``cudaStreamSynchronize``, by the innermost span around them, the
    ``top`` longest)}, or None without device events. The profiler
    mirrors each span onto the device's timeline (a GPU user
    annotation of the same name, from its first kernel to its last);
    those are no device work and are left out."""
    from torch.autograd import DeviceType

    from h100_bench import device_trace

    dev, spans, calls = [], [], []
    for e in events:
        start, name = e.start_ns(), e.name()
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith("exmc."):
                dev.append((start, start + e.duration_ns()))
        elif e.device_type() == DeviceType.CPU:
            if name.startswith("exmc."):
                spans.append((start, start + e.duration_ns(), name))
            elif name.startswith("cuda"):
                calls.append((start + e.duration_ns() // 2, e.duration_ns(), name))
    if not dev:
        return None
    d = np.asarray(dev, np.int64)
    ms, me = device_trace.busy_union(d[:, 0], d[:, 1])
    gap_s, gap_e = me[:-1], ms[1:]
    mids = (gap_s + gap_e) // 2
    lens = gap_e - gap_s
    sp = np.asarray([(a, b) for a, b, _ in spans], np.int64).reshape(-1, 2)
    span_names = [n for _, _, n in spans]
    labels = device_trace.innermost(sp[:, 0], sp[:, 1], span_names, mids.tolist())
    by = {}
    for lab, n in zip(labels, lens.tolist()):
        by[lab or OUTSIDE] = by.get(lab or OUTSIDE, 0) + n
    calls.sort()
    call_by = {}
    for lab, (_, n, name) in zip(device_trace.innermost(
            sp[:, 0], sp[:, 1], span_names, [c[0] for c in calls]), calls):
        key = (lab or OUTSIDE, name)
        call_by[key] = call_by.get(key, 0) + n
    tree = np.asarray(sorted((a, b) for a, b, n in spans if n == "exmc.tree"),
                      np.int64).reshape(-1, 2)
    idx = np.searchsorted(tree[:, 0], mids, side="right") - 1
    inside = (idx >= 0) & (mids <= tree[np.maximum(idx, 0), 1]) if len(tree) else \
        np.zeros(len(mids), bool)
    window_ns = window_s * 1e9
    return {"device_idle": 100.0 * (1.0 - float((me - ms).sum()) / window_ns),
            "tree_idle": 100.0 * float(lens[inside].sum()) / window_ns,
            "idle_spans": [[n, v / 1e9] for n, v in
                           sorted(by.items(), key=lambda kv: -kv[1])[:top]],
            "runtime_calls": [[lab, n, v / 1e9] for (lab, n), v in
                              sorted(call_by.items(), key=lambda kv: -kv[1])[:top]]}


def split(fits):
    """The span readings of ``fits`` ({"seconds", "host_syncs",
    "spans"}, the recorder on): self milliseconds per host sync by span
    name, the share of the fits' seconds per sync that ``exmc.vag``,
    ``exmc.tree`` and ``exmc.sync`` cover, and warmup's share."""
    syncs = sum(f["host_syncs"] for f in fits)
    names = sorted({n for f in fits for n in f["spans"]})

    def total(name, key):
        return sum(f["spans"].get(name, {}).get(key, 0.0) for f in fits)

    per_sync = {n: 1000.0 * total(n, "self_s") / syncs for n in names}
    ms = 1000.0 * sum(f["seconds"] for f in fits) / syncs
    three = sum(per_sync.get(n, 0.0) for n in ("exmc.vag", "exmc.tree", "exmc.sync"))
    return {"per_sync_ms": per_sync, "ms_per_sync": ms, "covered": 100.0 * three / ms,
            "warmup_share": 100.0 * total("exmc.warmup", "total_s") / total("exmc.fit", "total_s")}


def interleaved(prog, fits):
    """``fits`` whole fits of the cell in which each call of the model's
    value-and-grad switches the recorder on or off by a coin drawn from
    the cell's seed. The stretch from one call to the next (the call,
    then the tree's operations and the sync before the next leaf) runs
    in one state and counts toward it, so the host's drift, which moves
    a whole fit by ±10 % in eight schools, falls on both states alike. A
    coin, not turns: an iteration often makes an even number of calls,
    so turns would give one state the same stretches of every tree.
    Returns the stretches and their mean length (us) in each state, the
    change, on over off (%), with its standard error, over all the fits,
    and the change fit by fit. Run it before any profiled fit: after a
    profiler session the process launches kernels more slowly."""
    import random

    from exmc_tpu_torch.utils import profiling

    model = prog.sampler.model
    vag = model.value_and_grad
    clock = time.perf_counter_ns
    coin = random.Random(prog.seed).random
    sums = {False: [0, 0, 0], True: [0, 0, 0]}  # state -> [ns, stretches, ns^2]
    state = {"on": False, "t": None}

    def switching(*args, **kwargs):
        t = clock()
        if state["t"] is not None:
            dt = t - state["t"]
            s = sums[state["on"]]
            s[0] += dt
            s[1] += 1
            s[2] += dt * dt
        state["on"] = coin() < 0.5
        profiling.tracing(state["on"])
        state["t"] = clock()
        return vag(*args, **kwargs)

    def change(on, off):
        return 100.0 * ((on[0] / on[1]) / (off[0] / off[1]) - 1.0)

    per_fit, total = [], {False: [0, 0, 0], True: [0, 0, 0]}
    model.value_and_grad = switching
    try:
        for k in range(fits):
            state["t"] = None
            for s in sums.values():
                s[:] = [0, 0, 0]
            prog.fit(200 + k)
            per_fit.append(change(sums[True], sums[False]))
            for on in (False, True):
                total[on] = [x + y for x, y in zip(total[on], sums[on])]
    finally:
        model.value_and_grad = vag
        profiling.tracing(False)
    mean = {on: t[0] / t[1] for on, t in total.items()}
    var = {on: t[2] / t[1] - mean[on] ** 2 for on, t in total.items()}
    se = (var[True] / total[True][1] + var[False] / total[False][1]) ** 0.5
    return {"fits": fits, "stretches": {"off": total[False][1], "on": total[True][1]},
            "us_off": mean[False] / 1e3, "us_on": mean[True] / 1e3,
            "change": change(total[True], total[False]), "change_se": 100.0 * se / mean[False],
            "per_fit": per_fit}


def run_pairs(prog, pairs, profile):
    """Set-up done: the pairs of fits, then the profiled fit."""
    from exmc_tpu_torch.utils import profiling

    from h100_bench import harness

    off, on, fits = [], [], []
    for k in range(pairs):
        for traced in ((False, True) if k % 2 == 0 else (True, False)):
            with profiling.tracing(traced):
                fit = prog.fit(k)
            last = prog.sampler.last_run
            row = {"seconds": fit.seconds, "host_syncs": fit.host_syncs,
                   "iterations": fit.iterations, "spans": last.get("spans", {}),
                   "host_syncs_warmup": last.get("host_syncs_warmup")}
            (on if traced else off).append(row)
            if traced:
                fits.append(fit)
    out = {"pairs": [{"off_s": a["seconds"], "on_s": b["seconds"],
                      "host_syncs": a["host_syncs"], "same_syncs": a["host_syncs"] == b["host_syncs"]}
                     for a, b in zip(off, on)]}
    ms_off = 1000.0 * sum(f["seconds"] for f in off) / sum(f["host_syncs"] for f in off)
    s = split(on)
    n = 100_000
    with profiling.tracing(True):
        t = time.perf_counter()
        for _ in range(n):
            token = profiling.leaf_begin("exmc.cost")
            profiling.leaf_end("exmc.cost", token)
        leaf_us = 1e6 * (time.perf_counter() - t) / n
        t = time.perf_counter()
        for _ in range(n):
            with profiling.span("exmc.cost"):
                pass
        span_us = 1e6 * (time.perf_counter() - t) / n
    syncs = sum(f["host_syncs"] for f in on)
    leaves = sum(v["count"] for f in on for name, v in f["spans"].items()
                 if name in ("exmc.vag", "exmc.sync")) / syncs
    others = sum(v["count"] for f in on for v in f["spans"].values()) / syncs - leaves
    out.update(leaf_us=leaf_us, span_us=span_us,
               spans_per_sync={"leaf": leaves, "other": others},
               span_cost=100.0 * (leaves * leaf_us + others * span_us) / (1000.0 * ms_off))
    run = harness.Run(spec=prog.spec, config=prog.config, fits=fits, device=prog.device)
    out.update(ms_per_sync_off=ms_off, ms_per_sync_on=s["ms_per_sync"],
               on_cost=100.0 * (s["ms_per_sync"] / ms_off - 1.0), split=s["per_sync_ms"],
               covered=s["covered"], warmup_share=s["warmup_share"],
               counters={"live_rows.nuts": run.value("live_rows.nuts"),
                         "offtree_vag_per_iter.nuts": run.value("offtree_vag_per_iter.nuts"),
                         "host_syncs_warmup_share": 100.0 * sum(f["host_syncs_warmup"] for f in on)
                         / sum(f["host_syncs"] for f in on)})
    if profile and str(prog.device).startswith("cuda"):
        import torch
        from torch.profiler import ProfilerActivity

        torch.cuda.synchronize()
        with profiling.tracing(True), torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            prog.short_fit("profile_fit", pairs)
            window_s = time.perf_counter() - t
        out["profile"] = dict(idle_by_span(prof.profiler.kineto_results.events(), window_s),
                              window_s=window_s)
    return out


def main(argv):
    from h100_bench import harness

    ap = argparse.ArgumentParser(description="The program's spans and counters in one cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    ap.add_argument("--interleave", type=int, default=0)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    spec = harness.Spec.load(ROOT, args.workload)
    prog = harness.Program(spec, args.seed, "cuda")
    prog.warm_up()
    out = {"workload": args.workload, "seed": args.seed, "setup_s": time.perf_counter() - t0}
    if args.interleave:
        out["interleaved"] = interleaved(prog, args.interleave)
    if args.pairs:
        out.update(run_pairs(prog, args.pairs, bool(args.profile)))
    prog.free()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:]))
