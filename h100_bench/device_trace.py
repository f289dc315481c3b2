"""The device trace of one profiled fit: ``torch.profiler`` over the fit,
reduced to the device's busy time (the union of the intervals in which a
kernel, copy or fill ran), the kernels that took the most device time,
the idle gaps summed by the host operation that was running in them, and
the device time of the work that CUDA graph launches ran (the union of
the intervals of the kernels whose correlation id is a
``cudaGraphLaunch``'s) with the number of those launches. The method of
the port's ``bench.profile``, with the union in place of a sum so that
overlapping work is counted once."""

import time

import numpy as np

TOP = 10
NAME_CHARS = 160
GRAPH_LAUNCH = "cudaGraphLaunch"


def profiled(fn, device):
    """Run ``fn`` under the profiler; returns the reduced trace, or None
    off the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not str(device).startswith("cuda"):
        return None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t
    t = time.perf_counter()
    out = reduce(prof.profiler.kineto_results.events(), window_s)
    out["reduce_s"] = time.perf_counter() - t
    return out


def _name(s):
    return s if len(s) <= NAME_CHARS else s[:NAME_CHARS - 3] + "..."


def busy_union(starts, ends):
    """Merged intervals of (starts, ends), sorted: (m_starts, m_ends)."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(run_end[idx[1:] - 1], run_end[-1])


def innermost(op_starts, op_ends, op_names, points):
    """For each of the sorted ``points``, the name of the innermost
    interval of the properly nested ops that holds it, or "" where none
    does."""
    order = np.argsort(op_starts, kind="stable")
    labels = []
    stack = []
    i = 0
    for p in points:
        while i < len(order) and op_starts[order[i]] <= p:
            j = order[i]
            while stack and op_ends[stack[-1]] < op_starts[j]:
                stack.pop()
            stack.append(j)
            i += 1
        while stack and op_ends[stack[-1]] < p:
            stack.pop()
        labels.append(op_names[stack[-1]] if stack else "")
    return labels


def reduce(events, window_s):
    """Reduce kineto events to busy_s, window_s, device_ops, idle_gaps,
    graph_busy_s and graph_launches (seconds, unrounded)."""
    from torch.autograd import DeviceType

    dev_s, dev_e, dev_n, dev_c = [], [], [], []
    cpu = {}
    launches = set()
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            dev_s.append(start)
            dev_e.append(end)
            dev_n.append(e.name())
            dev_c.append(e.correlation_id())
        elif e.device_type() == DeviceType.CPU:
            cpu.setdefault(e.start_thread_id(), []).append((start, end, e.name()))
            if e.name().startswith(GRAPH_LAUNCH):
                launches.add(e.correlation_id())
    if not dev_s:
        return {"busy_s": 0.0, "window_s": window_s, "device_ops": [], "idle_gaps": [],
                "kernels": 0, "graph_busy_s": 0.0, "graph_launches": 0}
    starts, ends = np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64)
    in_graph = np.fromiter((c in launches for c in dev_c), bool, len(dev_c))
    launched = {c for c in dev_c if c in launches}
    graph_ns = 0
    if in_graph.any():
        gs, ge = busy_union(starts[in_graph], ends[in_graph])
        graph_ns = int((ge - gs).sum())
    per = {}
    for n, d in zip(dev_n, (ends - starts).tolist()):
        per[n] = per.get(n, 0) + d
    ms, me = busy_union(starts, ends)
    busy_ns = int((me - ms).sum())
    gap_s, gap_e = me[:-1], ms[1:]
    gaps = {}
    if len(gap_s):
        main = max(cpu.values(), key=len) if cpu else []
        ops = np.asarray([(a, b) for a, b, _ in main], np.int64).reshape(-1, 2)
        labels = innermost(ops[:, 0], ops[:, 1], [n for _, _, n in main],
                           ((gap_s + gap_e) // 2).tolist())
        for lab, d in zip(labels, (gap_e - gap_s).tolist()):
            lab = lab or "host outside any operation"
            gaps[lab] = gaps.get(lab, 0) + d
    top = sorted(per.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_ns / 1e9, "window_s": window_s,
            "device_ops": [[_name(n), d / 1e9] for n, d in top],
            "idle_gaps": [[_name(n), d / 1e9] for n, d in top_gaps],
            "kernels": len(dev_s), "graph_busy_s": graph_ns / 1e9,
            "graph_launches": len(launched)}
