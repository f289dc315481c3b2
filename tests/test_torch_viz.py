"""The port's live terminal monitor (``exmc_tpu_torch.viz``) against the
JAX package's: ``sparkline`` and ``LiveMonitor``'s frames and summary
strings equal, chunk for chunk, on the same numpy chunks (the frames
with their draws/s rate masked: a clock reading), and example 46's path
(``sample_stream`` into a ``LiveMonitor`` and a ``TraceStore``) on the
CPU.
"""

import io
import re

import numpy as np
import pytest

from exmc_tpu_torch import Builder, dists
from exmc_tpu_torch.benchmarks.parallel import example46_ir
from exmc_tpu_torch.nuts.sampler import sample_stream
from exmc_tpu_torch.utils import TraceStore
from exmc_tpu_torch.viz import LiveMonitor, sparkline

RATE = re.compile(r"[\d,]+ draws/s")

SPARK_INPUTS = {
    "ramp": (np.arange(10.0), 10), "empty": ([], 5), "long": (None, 28),
    "constant": (np.full(7, 3.0), 12), "nan": (np.array([1.0, np.nan, 3.0, 2.0]), 6),
    "short": (np.array([2.0, -1.0]), 9),
}


@pytest.mark.parametrize("name", sorted(SPARK_INPUTS))
def test_sparkline_matches_jax(name):
    from exmc_tpu.viz import sparkline as jax_sparkline

    values, width = SPARK_INPUTS[name]
    if values is None:
        values = np.random.default_rng(0).normal(size=200)
    assert sparkline(values, width=width) == jax_sparkline(values, width=width)
    assert len(sparkline(values, width=width)) == width


def _chunks(seed=3, chains=6, total=240, chunk=30):
    rng = np.random.default_rng(seed)
    for start in range(0, total, chunk):
        k = min(chunk, total - start)
        tr = {"mu": rng.normal(2.0, 1.0, size=(chains, k)),
              "theta": rng.normal(size=(chains, k, 3)) + np.arange(3)}
        st = {"diverging": rng.random((chains, k)) < 0.05}
        yield start, tr, st


@pytest.mark.parametrize("ansi", [False, True])
def test_live_monitor_matches_jax_chunk_for_chunk(ansi):
    from exmc_tpu.viz import LiveMonitor as JaxMonitor

    bufs = [io.StringIO(), io.StringIO()]
    mons = [cls(num_chains=6, total_draws=240, stream=buf, ansi=ansi, max_rows=3)
            for cls, buf in zip((LiveMonitor, JaxMonitor), bufs)]
    for start, tr, st in _chunks():
        sizes = [len(b.getvalue()) for b in bufs]
        for mon in mons:
            mon(start, tr, st)
        frames = [RATE.sub("RATE", b.getvalue()[n:]) for b, n in zip(bufs, sizes)]
        assert frames[0] == frames[1]
        assert mons[0].render_summary() == mons[1].render_summary()
    assert "theta[1]" in mons[0].render_summary()


def test_live_monitor_streams_and_summarizes():
    ys = np.array([2.1, 1.8, 2.5, 2.0, 1.9, 2.3, 2.2, 1.7, 2.4, 2.6])
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = Builder.rv(ir, "sigma", dists.HalfNormal, {"sigma": 2.0})
    ir = Builder.rv(ir, "x", dists.Normal, {"mu": "mu", "sigma": "sigma"})
    ir = Builder.obs(ir, "x_obs", "x", ys)
    buf = io.StringIO()
    mon = LiveMonitor(num_chains=4, total_draws=60, stream=buf, ansi=False)
    trace, _ = sample_stream(ir, mon, num_chains=4, chunk_size=30, num_warmup=60,
                             num_samples=60, seed=0, device="cpu")
    out = buf.getvalue()
    assert "exmc_tpu live" in out and "R-hat" in out and "draws/s" in out
    assert "draw 60/60" in out
    summary = mon.render_summary()
    assert "streamed 60 draws x 4 chains" in summary
    line = [ln for ln in summary.splitlines() if ln.strip().startswith("mu")][0]
    assert abs(float(line.split("mean")[1].split("sd")[0]) - float(trace["mu"].mean())) < 1e-3


def test_live_monitor_vector_params_and_row_cap():
    rng = np.random.default_rng(0)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "v", dists.Normal, {"mu": 0.0, "sigma": 1.0}, shape=(5,))
    ir = Builder.rv(ir, "y", dists.Normal, {"mu": "v", "sigma": 1.0}, shape=(5,))
    ir = Builder.obs(ir, "y_obs", "y", rng.normal(size=5))
    buf = io.StringIO()
    mon = LiveMonitor(num_chains=4, total_draws=60, stream=buf, ansi=False, max_rows=3)
    sample_stream(ir, mon, num_chains=4, chunk_size=100, num_warmup=60, num_samples=60,
                  seed=1, device="cpu")
    out = buf.getvalue()
    assert "v[0]" in out and "v[2]" in out and "v[3]" not in out


def test_live_monitor_early_rhat_and_moment_exactness():
    """The 8-segment accumulator gives a finite R-hat at 30 % of the
    stream, and its moments match the batch values."""
    rng = np.random.default_rng(7)
    mon = LiveMonitor(num_chains=4, total_draws=1000, stream=io.StringIO(), ansi=False)
    draws = rng.normal(loc=3.0, size=(4, 300))
    for s in range(0, 300, 100):
        mon(s, {"x": draws[:, s:s + 100]}, {})
    line = [ln for ln in mon.render_summary().splitlines() if "x" in ln][-1]
    assert "nan" not in line and "--" not in line
    assert abs(float(line.split("mean")[1].split("sd")[0]) - draws.mean()) < 5e-4
    sd = float(line.split("sd")[1].split("R-hat")[0])
    assert abs(sd - draws.std()) < 0.02 * draws.std()


def test_example46_path_streams_into_monitor_and_store(tmp_path):
    """Example 46's eight schools streamed (8 chains, 40 + 60, chunks of
    30) into a LiveMonitor and a TraceStore at once."""
    buf = io.StringIO()
    mon = LiveMonitor(num_chains=8, total_draws=60, params=["mu", "tau"], stream=buf,
                      ansi=False)
    store = TraceStore(tmp_path / "run")
    to_store = store.as_callback()

    def both(start, trace_chunk, stats_chunk):
        mon(start, trace_chunk, stats_chunk)
        to_store(start, trace_chunk, stats_chunk)

    trace, _ = sample_stream(example46_ir(), both, num_chains=8, chunk_size=30,
                             num_warmup=40, num_samples=60, seed=0, device="cpu")
    assert abs(float(trace["mu"].mean()) - 4.4) < 1.5
    np.testing.assert_array_equal(TraceStore.open(tmp_path / "run").load("tau"), trace["tau"])
    assert "streamed 60 draws x 8 chains" in mon.render_summary()
    assert "theta" not in buf.getvalue()
