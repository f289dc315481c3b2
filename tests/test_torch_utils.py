"""The port's run tools (``exmc_tpu_torch.utils``): checkpoints and the
trace store against the JAX package's files (the same on-disk formats,
each package reading the other's), and the profiling hooks on the CPU.
"""

import json
import os

import numpy as np
import pytest

import exmc_tpu_torch
from exmc_tpu_torch.benchmarks.parallel import simple_ir
from exmc_tpu_torch.nuts.sampler import _make_sampler, sample, sample_stream
from exmc_tpu_torch.utils import (
    TraceStore,
    annotate,
    annotated_run,
    load_checkpoint,
    phase_report,
    save_checkpoint,
    trace_profile,
)


def _stats(chains=3, d=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"step_size": rng.uniform(0.1, 1.0, chains).astype(np.float32),
            "inv_mass": rng.uniform(0.5, 2.0, (chains, d)).astype(np.float32)}


def test_checkpoint_roundtrip_and_resume(tmp_path):
    _, stats = sample(simple_ir(), num_warmup=100, num_samples=40, seed=1, device="cpu")
    path = tmp_path / "ckpt.npz"
    save_checkpoint(path, stats, seed=1)
    ckpt = load_checkpoint(path)
    np.testing.assert_array_equal(ckpt["warm_start"]["step_size"], stats["step_size"])
    assert int(ckpt["seed"]) == 1
    trace2, _ = sample(simple_ir(), num_samples=40, seed=2, device="cpu",
                       warm_start=ckpt["warm_start"])
    assert abs(float(trace2["mu"].mean()) - 2.1) < 0.4


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_files_read_across_packages(tmp_path, writer):
    from exmc_tpu.utils import load_checkpoint as jax_load
    from exmc_tpu.utils import save_checkpoint as jax_save

    stats, pos = _stats(), np.arange(6.0).reshape(3, 2)
    save, load = (save_checkpoint, jax_load) if writer == "port" else (jax_save, load_checkpoint)
    path = tmp_path / "ckpt.npz"
    save(path, stats, seed=7, positions=pos, extra={"note": [1, 2]})
    got = load(path)
    np.testing.assert_array_equal(got["warm_start"]["inv_mass"], stats["inv_mass"])
    np.testing.assert_array_equal(got["positions"], pos)
    np.testing.assert_array_equal(got["extra_note"], [1, 2])
    assert sorted(got) == sorted(["step_size", "inv_mass", "positions", "seed", "extra_note",
                                  "warm_start"])


def test_trace_store_streaming(tmp_path):
    """Chunks land on disk as they arrive; reading is chunk-lazy and the
    concatenation is the returned trace."""
    store = TraceStore(tmp_path / "run1")
    trace, stats = sample_stream(simple_ir(), store.as_callback(), num_samples=60,
                                 chunk_size=25, num_warmup=40, seed=0, num_chains=2,
                                 device="cpu")
    reopened = TraceStore.open(tmp_path / "run1")
    assert reopened.num_samples == 60 and "mu" in reopened.variables()
    np.testing.assert_array_equal(reopened.load("mu"), trace["mu"])
    assert reopened.load("diverging", kind="stat").shape == stats["diverging"].shape
    assert abs(reopened.running_mean("mu") - trace["mu"].mean()) < 1e-6
    seen = 0
    for start, tr, _ in reopened.iter_chunks():
        assert start == seen
        seen += tr["mu"].shape[1]
    assert seen == 60


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trace_store_read_across_packages(tmp_path, writer):
    from exmc_tpu.utils import TraceStore as JaxStore

    rng = np.random.default_rng(1)
    chunks = [(0, {"mu": rng.normal(size=(4, 5)), "theta": rng.normal(size=(4, 5, 3))},
               {"diverging": rng.random((4, 5)) < 0.1}),
              (5, {"mu": rng.normal(size=(4, 3)), "theta": rng.normal(size=(4, 3, 3))},
               {"diverging": rng.random((4, 3)) < 0.1})]
    cls_w, cls_r = (TraceStore, JaxStore) if writer == "port" else (JaxStore, TraceStore)
    store = cls_w(tmp_path / "run")
    for start, tr, st in chunks:
        store.append(start, tr, st)
    back = cls_r.open(tmp_path / "run")
    assert back.num_samples == 8 and back.variables() == ["mu", "theta"]
    np.testing.assert_array_equal(back.load("theta"),
                                  np.concatenate([c[1]["theta"] for c in chunks], axis=1))
    np.testing.assert_array_equal(back.load("diverging", kind="stat"),
                                  np.concatenate([c[2]["diverging"] for c in chunks], axis=1))


def test_phase_report_breakdown():
    report, (trace, _) = phase_report(simple_ir(), num_chains=2, num_warmup=60,
                                      num_samples=40, device="cpu")
    for k in ("build_and_compile_model_s", "compile_and_first_run_s", "pipeline_run_s",
              "constrain_s", "diagnostics_s", "compile_over_run"):
        assert k in report
    assert report["pipeline_run_s"] > 0
    assert abs(float(np.mean(trace["mu"])) - 2.1) < 0.4


def test_annotated_run_trace_has_its_spans(tmp_path):
    sampler = _make_sampler(simple_ir(), num_warmup=20, num_samples=10, device="cpu")
    trace, _ = annotated_run(sampler, num_chains=2, seed=0, logdir=str(tmp_path / "trace"))
    assert trace["mu"].shape == (2, 10) and np.isfinite(trace["mu"]).all()
    with open(tmp_path / "trace" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"exmc:compile+first-run", "exmc:sampling"} <= names


def test_trace_profile_records_annotations(tmp_path):
    import torch

    with trace_profile(tmp_path / "t") as logdir:
        with annotate("exmc:block"):
            torch.ones(4).sum()
    assert logdir == str(tmp_path / "t")
    with open(os.path.join(logdir, "trace.json")) as f:
        assert "exmc:block" in {e.get("name") for e in json.load(f)["traceEvents"]}
    with annotate("outside a profiler"):  # a plain span costs nothing
        pass


def test_utils_all_is_the_jax_packages():
    import exmc_tpu.utils

    import exmc_tpu_torch.utils

    assert exmc_tpu_torch.utils.__all__ == exmc_tpu.utils.__all__
    assert exmc_tpu_torch.utils.TraceStore is TraceStore
    assert exmc_tpu_torch.Builder  # the package imports with its new subpackages


@pytest.mark.parametrize("path", [
    "parallel/__init__.py", "parallel/sharding.py", "parallel/distributed.py",
    "parallel/diagnostics.py", "utils/__init__.py", "utils/checkpoint.py",
    "utils/fault_injector.py", "utils/profiling.py", "utils/trace_store.py", "viz.py",
    "benchmarks/parallel.py"])
def test_new_modules_import_no_jax(path):
    """The slice's modules import torch and numpy, never JAX or the JAX
    package (the numpy-only ones keep their own copies)."""
    import re

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = open(os.path.join(root, "exmc_tpu_torch", path)).read()
    assert not re.search(r"^\s*(import|from) (jax|exmc_tpu)(\.|\s|$)", src, re.M)
