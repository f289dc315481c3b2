"""The readers of the program's counters, the labelling of idle gaps by
the program's spans, and the spans tool, by hand and on the CPU."""

import math
from types import SimpleNamespace

import numpy as np

from h100_bench import harness, spans
from smallsizes import small_spec


def _fit(leaf, warm, draws, other=None, iterations=30):
    stats = {"n_steps_warmup": np.asarray(warm), "n_steps": np.asarray(draws),
             "vag_calls": dict({"leaf": leaf}, **(other or {}))}
    return SimpleNamespace(stats=stats, iterations=iterations,
                           n_steps=int(np.asarray(draws).sum()))


def _run(fits):
    return harness.Run(spec=SimpleNamespace(traffic={"chains": 2}), config=None,
                       fits=fits, device="cuda")


def test_counter_readers_by_hand():
    # two chains: 100 leaves, so 200 rows; 30 + 50 warmup and 20 + 10 draws' steps
    a = _fit(100, [30, 50], [[10, 10], [5, 5]],
             {"init": 1, "eps_search": 8, "recovery": 30, "rescue": 1})
    b = _fit(20, [4, 6], [[2], [3]], {"recovery": 10}, iterations=10)
    run = _run([a, b])
    assert math.isclose(run.value("live_rows.nuts"),
                        100.0 * (80 + 30 + 10 + 5) / (200 + 40))
    assert math.isclose(run.value("offtree_vag_per_iter.nuts"), (40 + 10) / 40)


def test_counter_readers_find_nothing_in_a_program_without_the_counters():
    old = SimpleNamespace(stats={"n_steps": np.ones((2, 3))}, iterations=30, n_steps=6)
    run = _run([old])
    assert run.value("live_rows.nuts") is None
    assert run.value("offtree_vag_per_iter.nuts") is None


class _Ev:
    def __init__(self, kind, start, end, name=""):
        self._v = (kind, start, end, name)

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CPU if self._v[0] == "cpu" else DeviceType.CUDA

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def name(self):
        return self._v[3]


def test_idle_gaps_by_span_by_hand():
    events = [
        # host: a fit holding a tree (with a sync and a model call inside) and an adapt
        _Ev("cpu", 0, 1000, "exmc.fit"), _Ev("cpu", 100, 600, "exmc.tree"),
        _Ev("cpu", 150, 250, "exmc.vag"), _Ev("cpu", 400, 600, "exmc.sync"),
        _Ev("cpu", 700, 800, "exmc.adapt"), _Ev("cpu", 410, 420, "aten::item"),
        # device: busy 0-100, 200-300, 500-700, 900-950
        _Ev("kernel", 0, 60), _Ev("kernel", 50, 100), _Ev("kernel", 200, 300),
        _Ev("kernel", 500, 700), _Ev("kernel", 900, 950),
    ]
    out = spans.idle_by_span(events, 1000e-9)
    # gaps: 100-200 (mid 150: exmc.vag), 300-500 (mid 400: exmc.sync),
    # 700-900 (mid 800: exmc.adapt's end, so exmc.adapt)
    assert dict((n, round(s * 1e9)) for n, s in out["idle_spans"]) == {
        "exmc.vag": 100, "exmc.sync": 200, "exmc.adapt": 200}
    assert math.isclose(out["device_idle"], 100.0 * (1 - 450 / 1000))
    assert math.isclose(out["tree_idle"], 100.0 * 300 / 1000)
    bare = [_Ev("kernel", 0, 10), _Ev("kernel", 20, 30)]
    out = spans.idle_by_span(bare, 30e-9)
    assert out["idle_spans"] == [[spans.OUTSIDE, 10e-9]] and out["tree_idle"] == 0.0
    assert spans.idle_by_span([_Ev("cpu", 0, 5, "exmc.fit")], 1.0) is None


def test_split_by_hand():
    fits = [{"seconds": 2.0, "host_syncs": 1000, "spans": {
        "exmc.fit": {"total_s": 2.0, "self_s": 0.0},
        "exmc.warmup": {"total_s": 1.5, "self_s": 0.1},
        "exmc.tree": {"total_s": 1.6, "self_s": 0.5},
        "exmc.vag": {"total_s": 0.3, "self_s": 0.3},
        "exmc.sync": {"total_s": 0.8, "self_s": 0.8}}}]
    s = spans.split(fits)
    assert math.isclose(s["ms_per_sync"], 2.0)
    assert math.isclose(s["per_sync_ms"]["exmc.tree"], 0.5)
    assert math.isclose(s["covered"], 100.0 * 1.6 / 2.0)
    assert math.isclose(s["warmup_share"], 75.0)


def test_a_run_without_trace_leaves_program_tracing_off():
    from exmc_tpu_torch.utils import profiling

    before = profiling.last_spans()
    keep = {}
    result, _ = harness.run_cell(small_spec("eight_schools.nuts"), 2**31 + 5, 0.1, False,
                                 device="cpu", keep=keep)
    assert result["correct"] and not profiling.TRACING
    assert profiling.last_spans() == before
    run = _run(keep["fits"])
    assert 0.0 < run.value("live_rows.nuts") <= 100.0
    assert run.value("offtree_vag_per_iter.nuts") >= 1.0


def test_the_spans_tool_on_the_cpu():
    from exmc_tpu_torch.utils import profiling

    spec = small_spec("eight_schools.nuts")
    spec.traffic["profile_fit"] = [10, 5]
    prog = harness.Program(spec, 2**31 + 9, "cpu")
    prog.warm_up()
    out = spans.run_pairs(prog, 1, profile=True)
    vag = prog.sampler.model.value_and_grad
    cost = spans.interleaved(prog, 2)
    assert prog.sampler.model.value_and_grad is vag and not profiling.TRACING
    prog.free()
    assert len(cost["per_fit"]) == 2 and min(cost["stretches"].values()) > 0
    assert cost["us_on"] > 0 and cost["us_off"] > 0
    assert math.isfinite(cost["change"]) and cost["change_se"] > 0
    assert {"leaf", "other"} == set(out["spans_per_sync"]) and out["leaf_us"] > 0
    assert out["pairs"][0]["same_syncs"]
    assert 0.0 < out["covered"] <= 100.0 and 0.0 < out["warmup_share"] < 100.0
    assert {"exmc.vag", "exmc.tree", "exmc.sync", "exmc.adapt"} <= set(out["split"])
    assert 0.0 < out["counters"]["live_rows.nuts"] <= 100.0
    assert "profile" not in out  # no card
