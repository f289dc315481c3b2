"""The shape-based counts, the readers that use them, and the reduction
of a device trace, against hand counts."""

import math
from types import SimpleNamespace

import numpy as np

from h100_bench import device_trace, harness, peaks

CFG = {"rows": 10, "columns": 3}


def _config():
    return harness.load_module(harness.HERE / "configs" / "covtype_logistic.py")


def test_vag_flops_and_bytes_by_hand():
    c = _config()
    # X (10 x 3) @ B (3 x 2): 60 multiply-adds; X^T (3 x 10) @ R (10 x 2): 60 more
    assert c.vag_flops(CFG, 2) == 240.0
    # X and y in float32 (120 + 40 bytes), points and gradients 2 x 4 x 4 each way
    assert c.vag_bytes(CFG, 2) == 224.0


def _run(**kw):
    spec = SimpleNamespace(cfg=CFG, traffic={"chains": 2})
    run = harness.Run(spec=spec, config=_config(), fits=kw.pop("fits", []),
                      device=kw.pop("device", "cuda"))
    run._values.update(kw)
    return run


def test_roofline_and_mfu_readers():
    run = _run(vag_ms=1e-6)
    share = run.value("vag_roofline")
    bound = max(240.0 / peaks.FLOAT32_FLOPS, 224.0 / peaks.HBM_BYTES_PER_S)
    assert math.isclose(share, 100.0 * bound / 1e-9)
    fit = SimpleNamespace(host_syncs=1000, seconds=2.0)
    assert math.isclose(_run(fits=[fit]).value("step_mfu"),
                        100.0 * 1000 * 240.0 / (2.0 * peaks.FLOAT32_FLOPS))
    assert _run(fits=[fit], device="cpu").value("step_mfu") is None


def test_counter_readers():
    fits = [SimpleNamespace(host_syncs=300, iterations=30, seconds=0.6, n_steps=2000,
                            min_ess=500.0),
            SimpleNamespace(host_syncs=100, iterations=10, seconds=0.2, n_steps=1000,
                            min_ess=100.0)]
    run = _run(fits=fits)
    assert run.value("syncs_per_iter.nuts") == 10.0
    assert math.isclose(run.value("ms_per_sync.nuts"), 2.0)
    assert math.isclose(run.value("ess_per_kgrad"), 200.0)
    assert _run(fits=[]).value("ess_per_kgrad") is None


class _Ev:
    def __init__(self, kind, start, end, name, tid=1, corr=0):
        self._v = (kind, start, end, name, tid, corr)

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CPU if self._v[0] == "cpu_op" else DeviceType.CUDA

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def name(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]


def test_trace_reduction_by_hand():
    events = [_Ev("kernel", 0, 10, "k1"), _Ev("kernel", 5, 20, "k2"),
              _Ev("kernel", 30, 40, "k1"), _Ev("gpu_memcpy", 45, 50, "copy"),
              _Ev("cpu_op", 0, 100, "aten::add"), _Ev("cpu_op", 22, 28, "aten::item"),
              _Ev("cpu_op", 41, 44, "aten::other", tid=2)]
    out = device_trace.reduce(events, 1e-7)
    # union [0, 20] + [30, 40] + [45, 50] = 35 ns
    assert out["busy_s"] == 35e-9 and out["window_s"] == 1e-7
    assert out["device_ops"] == [["k1", 20e-9], ["k2", 15e-9], ["copy", 5e-9]]
    # gap [20, 30] (middle 25) inside aten::item; gap [40, 45] (middle 42)
    # only inside aten::add on the main thread
    assert out["idle_gaps"] == [["aten::item", 10e-9], ["aten::add", 5e-9]]
    assert out["graph_launches"] == 0 and out["graph_busy_s"] == 0.0
    assert device_trace.reduce([], 1.0)["busy_s"] == 0.0


def test_graph_launches_device_time_by_hand():
    # two graph launches (correlation 7 and 9) run three kernels, one
    # kernel overlapping another; a kernel launched on its own (8) and a
    # launch whose kernels the trace lost (11) do not count
    events = [_Ev("cpu_op", 0, 4, "cudaGraphLaunch", corr=7),
              _Ev("cpu_op", 5, 6, "cudaLaunchKernel", corr=8),
              _Ev("cpu_op", 20, 24, "cudaGraphLaunch", corr=9),
              _Ev("cpu_op", 40, 44, "cudaGraphLaunch", corr=11),
              _Ev("kernel", 4, 10, "g1", corr=7), _Ev("kernel", 10, 14, "g2", corr=7),
              _Ev("kernel", 12, 18, "solo", corr=8),
              _Ev("kernel", 24, 30, "g1", corr=9), _Ev("kernel", 26, 28, "g2", corr=9)]
    out = device_trace.reduce(events, 1e-7)
    # [4, 14] and [24, 30]: 16 ns over two launches
    assert out["graph_busy_s"] == 16e-9 and out["graph_launches"] == 2
    run = _run()
    run.profile = out
    assert math.isclose(run.value("vag_ms"), 1000.0 * 8e-9)
    run = _run()
    run.profile = {"graph_busy_s": 0.0, "graph_launches": 0}
    assert run.value("vag_ms") is None


def test_device_idle_reader():
    run = _run()
    run.profile = {"busy_s": 0.25, "window_s": 1.0}
    assert run.value("device_idle") == 75.0
    run = _run()
    assert run.value("device_idle") is None


def test_busy_union():
    s, e = device_trace.busy_union(np.array([5, 0, 30, 12]), np.array([8, 10, 31, 15]))
    assert s.tolist() == [0, 12, 30] and e.tolist() == [10, 15, 31]
