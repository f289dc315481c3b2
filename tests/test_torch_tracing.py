"""The span recorder (``exmc_tpu_torch.utils.profiling``) and the run's
counters on the NUTS path, on the CPU (one test on the card): tracing
changes no draw, records nothing while it is off, and its spans and the
counters agree with each other and with the host-sync count."""

import json

import numpy as np
import pytest
import torch

from exmc_tpu_torch.benchmarks.entry import _same_run
from exmc_tpu_torch.marginal import LaplaceCounters
from exmc_tpu_torch.nuts.masked import HostSyncs
from exmc_tpu_torch.benchmarks.parallel import simple_ir
from exmc_tpu_torch.nuts.sampler import VAG_SITES, _make_sampler, sample_stream
from exmc_tpu_torch.utils import profiling

WARM, DRAWS = 40, 20


def _sampler(**opts):
    return _make_sampler(simple_ir(), num_warmup=WARM, num_samples=DRAWS, device="cpu",
                         **opts)


def _fit(mode, chains=5, seed=3):
    """(sampler, (trace, stats)) of one fit in ``mode``."""
    if mode == "stream":
        smp = _sampler()
        out = sample_stream(simple_ir(), lambda *a: None, num_chains=chains, seed=seed,
                            device="cpu", every=4, mechanism="io_callback",
                            num_warmup=WARM, num_samples=DRAWS)
        return smp, out
    if mode == "shared_warmup":
        smp = _sampler(shared_warmup=True)
        return smp, smp.run(num_chains=chains, seed=seed)
    smp = _sampler()
    if mode == "run_chunked":
        return smp, smp.run_chunked(num_chains=chains, seed=seed, chunk_iters=17)
    return smp, smp.run(num_chains=chains, seed=seed)


MODES = ["run", "run_chunked", "stream", "shared_warmup"]


@pytest.mark.parametrize("mode", ["run", "run_chunked"])
def test_tracing_changes_no_draw_and_no_count(mode):
    smp, off = _fit(mode)
    counts_off = dict(smp.last_run)
    with profiling.tracing(True):
        smp, on = _fit(mode)
    counts_on = dict(smp.last_run)
    assert _same_run(off, on)
    assert "spans" in counts_on and "spans" not in counts_off
    del counts_on["spans"]
    assert counts_on == counts_off


def test_tracing_off_records_nothing():
    with profiling.tracing(True, keep=True):
        _fit("run")
    before = profiling.last_spans()
    assert not profiling.TRACING and before
    smp, _ = _fit("run")
    assert "spans" not in smp.last_run
    assert profiling.last_spans() == before


def _check_counts(smp, stats):
    run = smp.last_run
    spans = run["spans"]
    assert spans["exmc.sync"]["count"] == run["host_syncs"]
    assert spans["exmc.vag"]["count"] == sum(run["vag_calls"].values())
    # a model call and a host sync open no span inside them
    assert all(spans[n]["self_s"] == spans[n]["total_s"] for n in ("exmc.sync", "exmc.vag"))
    assert spans["exmc.fit"]["count"] == 1 and spans["exmc.finish"]["count"] == 1
    assert spans["exmc.tree"]["count"] == run["iterations"]
    assert all(s["self_s"] >= 0 and s["total_s"] >= s["self_s"] for s in spans.values())
    assert {"exmc.init", "exmc.warmup", "exmc.draws", "exmc.adapt", "exmc.recovery",
            "exmc.eps_search"} <= set(spans)
    assert stats["host_syncs"] == run["host_syncs"]
    return spans


@pytest.mark.parametrize("mode", MODES)
def test_unkept_spans_keep_their_counts_only(mode):
    """By default the recorder reduces each span as it closes and keeps
    none of them."""
    with profiling.tracing(True):
        smp, (_, stats) = _fit(mode)
    _check_counts(smp, stats)
    assert profiling.last_spans() == []


@pytest.mark.parametrize("mode", MODES)
def test_spans_agree_with_the_counts(mode):
    with profiling.tracing(True, keep=True):
        smp, (_, stats) = _fit(mode)
    spans = _check_counts(smp, stats)
    # each span's children fit inside it, and the fit holds every span of the run
    closed = profiling.last_spans()
    by_id = {s.id: s for s in closed}
    inner = {}
    for s in closed:
        if s.parent in by_id:
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
            inner[s.parent] = inner.get(s.parent, 0) + s.end_ns - s.start_ns
    assert all(inner.get(i, 0) <= s.end_ns - s.start_ns for i, s in by_id.items())
    assert len({s.run for s in closed}) == 1
    assert sum(s.name == "exmc.fit" for s in closed) == 1
    # the kept spans reduce to the same counts
    assert {n: sum(s.name == n for s in closed) for n in spans} == {
        n: v["count"] for n, v in spans.items()}


@pytest.mark.parametrize("mode", MODES)
def test_host_sync_counts_in_stats(mode):
    smp, (_, stats) = _fit(mode)
    run = smp.last_run
    assert stats["host_syncs"] == run["host_syncs"]
    assert 0 < run["host_syncs_warmup"] < run["host_syncs"]
    assert stats["vag_calls"] == run["vag_calls"] and tuple(run["vag_calls"]) == VAG_SITES
    assert run["vag_calls"]["recovery"] == run["iterations"]
    assert stats["n_steps_warmup"].shape == stats["step_size"].shape


@pytest.mark.parametrize("mode", ["run", "run_chunked", "shared_warmup"])
def test_a_single_chain_is_never_masked(mode):
    smp, (_, stats) = _fit(mode, chains=1)
    steps = int(stats["n_steps_warmup"].sum()) + int(stats["n_steps"].sum())
    assert steps == smp.last_run["vag_calls"]["leaf"]
    assert stats["n_steps_warmup"].min() > 0


def test_resume_from_a_checkpoint_without_the_counts(tmp_path):
    """A checkpoint written before the run counted warmup's steps and its
    value-and-grad calls resumes to the uninterrupted run's draws, stats
    and host syncs; those two counts start at the resume."""
    smp = _sampler()
    base = smp.run(num_chains=5, seed=3)
    syncs = smp.last_run["host_syncs"]
    ckpt, old = tmp_path / "ckpt.npz", tmp_path / "old.npz"

    def save_old(start, trace, stats):
        if not old.exists():
            with np.load(ckpt) as z:
                np.savez(old, **{k: z[k] for k in z.files
                                 if k not in ("carry.n_steps_warmup", "host_syncs_warmup")
                                 and not k.startswith("vag_calls.")})

    smp.run_chunked(num_chains=5, seed=3, chunk_iters=17, checkpoint_path=str(ckpt),
                    callback=save_old)
    trace, stats = smp.run_chunked(num_chains=5, seed=3, chunk_iters=17, resume_from=str(old))
    def without_counts(st):
        return {k: v for k, v in st.items() if k not in ("n_steps_warmup", "vag_calls")}

    assert _same_run((base[0], without_counts(base[1])), (trace, without_counts(stats)))
    run = smp.last_run
    assert run["host_syncs"] == stats["host_syncs"] == syncs
    assert run["host_syncs_warmup"] <= syncs
    # the steps and calls of the iterations after the resume
    assert (stats["n_steps_warmup"] < base[1]["n_steps_warmup"]).all()
    assert 0 < run["vag_calls"]["leaf"] < base[1]["vag_calls"]["leaf"]
    assert tuple(run["vag_calls"]) == VAG_SITES


@pytest.mark.parametrize("warmup", [None, 17])
def test_the_counts_come_back_from_a_checkpoint(tmp_path, warmup):
    """Every count of a run's record, written with ``payload`` into an
    .npz and read back with ``restore`` into a new record, comes back
    equal. The model's counters, which restart at a resume, keep their
    key in the stats."""
    lap = LaplaceCounters(3)
    saved = HostSyncs(lik_kernel=True, counters=(lap,))
    saved.count, saved.warmup, saved.leaf_kernel = 41, warmup, 29
    for i, site in enumerate(VAG_SITES):
        vag = saved.counted(lambda q: q, site)
        for _ in range(i + 1):
            vag(0)
    lap.add(torch.tensor(2.0, dtype=torch.float64), torch.tensor([1e-9, 1e-6]))
    want, want_stats = saved.report(), saved.stats()
    assert want_stats["laplace"]["calls"] == 1.0
    assert min(v for v in want.values() if not isinstance(v, dict)) > 0
    np.savez(tmp_path / "ckpt.npz", **saved.payload())
    back = HostSyncs(lik_kernel=True, counters=(lap,))
    with np.load(tmp_path / "ckpt.npz") as z:
        back.restore({k: z[k] for k in z.files})
    assert back.report() == want
    assert (back.count, back.warmup, back.vag_calls, back.leaf_kernel) == (
        saved.count, saved.warmup, saved.vag_calls, saved.leaf_kernel)
    got_stats = back.stats()
    assert tuple(got_stats) == HostSyncs.stat_keys((lap,)) == tuple(want_stats)
    assert {k: got_stats[k] for k in want_stats if k != "laplace"} == {
        k: want_stats[k] for k in want_stats if k != "laplace"}
    assert got_stats["laplace"]["calls"] == 0.0


def test_shared_warmup_steps_are_chain_zeros():
    _, (_, stats) = _fit("shared_warmup", chains=4)
    assert stats["n_steps_warmup"][0] > 0 and (stats["n_steps_warmup"][1:] == 0).all()


def test_profiler_trace_holds_the_spans(tmp_path):
    smp = _sampler()
    with profiling.tracing(True), profiling.trace_profile(tmp_path / "t") as logdir:
        smp.run(num_chains=3, seed=1)
    with open(f"{logdir}/trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"exmc.fit", "exmc.tree", "exmc.vag", "exmc.sync", "exmc.warmup",
            "exmc.draws"} <= names


def test_tracing_switch_and_annotate():
    assert not profiling.TRACING
    with profiling.tracing(True):
        assert profiling.TRACING
        with profiling.tracing(False):
            assert not profiling.TRACING
        assert profiling.TRACING
        with profiling.fit_spans() as spans:
            with profiling.annotate("exmc:block"):
                with profiling.span("inner"):
                    pass
    assert not profiling.TRACING
    assert spans["exmc:block"]["count"] == 1 and spans["inner"]["count"] == 1
    assert spans["exmc.fit"]["total_s"] >= spans["exmc:block"]["total_s"]
    with profiling.fit_spans() as off:
        with profiling.annotate("exmc:block"):
            pass
    assert off == {}


def test_an_exception_closes_the_spans_it_left_open():
    with profiling.tracing(True):
        with pytest.raises(RuntimeError):
            with profiling.fit_spans():
                profiling.begin("exmc.warmup")
                with profiling.span("exmc.tree"):
                    raise RuntimeError("a fault in the tree")
        with profiling.fit_spans() as spans:
            pass
    assert set(spans) == {"exmc.fit"}
    assert np.isfinite(spans["exmc.fit"]["self_s"])


@pytest.mark.gpu
def test_spans_on_the_card_with_a_capture_inside_the_fit():
    """On the card the model's value-and-grad replays a CUDA graph; the
    first call of a batch shape captures it. A capture inside a traced
    fit adds no ``exmc.vag`` span of its own, and tracing changes no
    draw."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from exmc_tpu_torch.compiler import GraphedValueAndGrad

    smp = _make_sampler(simple_ir(), num_warmup=WARM, num_samples=DRAWS, device="cuda")
    assert isinstance(smp.model.value_and_grad, GraphedValueAndGrad)
    with profiling.tracing(True):
        on = smp.run(num_chains=7, seed=2)  # the first (7, d) call captures
    run = smp.last_run
    assert run["spans"]["exmc.vag"]["count"] == sum(run["vag_calls"].values())
    assert run["spans"]["exmc.sync"]["count"] == run["host_syncs"]
    assert _same_run(on, smp.run(num_chains=7, seed=2))
