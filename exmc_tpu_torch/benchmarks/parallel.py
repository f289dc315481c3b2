"""The parallel package and the run tools driven on one card: the
``parallel`` phase of ``chip_smoke.py``. Each check returns one dict
with ``ok``, the list of ``failures`` and what it measured; the tests
run them on the CPU at small sizes (``SMALL``).

Multi-rank checks run in one group of ranks started by ``start_ranks``
(gloo; two ranks on one card share it, since NCCL refuses two ranks on
one GPU), one after another (``GROUP_TASKS``):

* ``parallel:eight_schools_dp2`` — eight schools with auto-NCP, 1024
  chains, 200 + 500, pooled adaptation, ensemble rescue, max depth 10,
  through ``sample_chains_sharded`` over dp = 2: mu 4.4 ± 0.3, tau 3.6 ±
  0.3, divergence rate < 2e-3, nested R-hat (K = 32) < 1.01, one inverse
  mass for all chains, and the sharded R-hat, ESS and nested R-hat on
  each rank's chains equal to the host versions on the gathered trace
  (relative 1e-5);
* ``parallel:logistic_sp2`` — the JAX package's
  ``scripts/multichip_bench.py::logistic_ir`` (n = 20,000, d = 21, the
  prior inside the Custom loglik, here in torch) at dp = 1, sp = 2, 64
  chains, 300 + 300: the data-parallel value and gradient equal the
  one-rank ones at 8 points (relative 1e-5 of the largest magnitude),
  the posterior means within 0.1 of a run over dp = 2, sp = 1, no
  divergences;
* ``parallel:fault_redispatch`` — a ``FaultInjector(kind="nan")`` run
  over dp = 2 in which every chain stays healthy, and a run with one
  chain's record poisoned after warmup that ``_redispatch_failed_chains``
  replaces with a healthy retry;
* ``parallel:chees_dp2`` — ChEES and SNAPER with ``mesh=`` over dp = 2
  on the 8-d Gaussian with sds 1..8 (``tests/test_chees.py``), 1024
  chains, 500 + 500: R-hat < 1.01, no divergences, sds within 20 %, and
  L equal on every rank at every iteration (``sample_chees`` checks it
  under a mesh and raises otherwise).

Each sharded run's line gives its ``host_syncs`` and, apart from them,
``host_staged_collectives``: the collectives of CUDA tensors that gloo
staged through the host (``Mesh.host_staged``).

``parallel:nccl_world1`` runs in a group of one rank on NCCL: the
collectives on CUDA tensors, the diagnostics and the data-parallel
value-and-grad equal to their unsharded forms, and a sharded run equal
to the unsharded run bit for bit. ``stream:example46`` (one process)
streams example 46 (eight schools, 16 chains, 500 + 1000, chunks of
100) through ``sample_stream`` into a ``LiveMonitor`` and a
``TraceStore``, and runs ``phase_report`` and ``annotated_run`` under a
profiler trace whose spans must be present.

    python -m exmc_tpu_torch.benchmarks.parallel [--device cpu] [--small]
"""

import argparse
import json
import multiprocessing
import multiprocessing.forkserver
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from exmc_tpu_torch import Builder, Model, bench, dists
from exmc_tpu_torch import diagnostics as diag
from exmc_tpu_torch.chees import sample_chees, sample_snaper
from exmc_tpu_torch.compiler import compile_logp
from exmc_tpu_torch.nuts.sampler import NUTSSampler, _make_sampler, sample_stream
from exmc_tpu_torch.ops.fused_leapfrog import fused_leapfrog_gaussian
from exmc_tpu_torch.parallel import (
    make_mesh,
    sample_chains_sharded,
    sharded_ess,
    sharded_nested_rhat,
    sharded_rhat,
)
from exmc_tpu_torch.parallel.distributed import _redispatch_failed_chains, initialize_distributed
from exmc_tpu_torch.parallel.sharding import make_data_parallel_vag, shard_data
from exmc_tpu_torch.utils import FaultInjector, TraceStore, annotated_run, phase_report
from exmc_tpu_torch.viz import LiveMonitor

GROUP_TASKS = ["parallel:eight_schools_dp2", "parallel:logistic_sp2",
               "parallel:fault_redispatch", "parallel:chees_dp2"]
GROUP_SIZE = 2

# fault_iters: (warmup, draws) of the faulted run and of the re-dispatched
# one (half the JAX tests', to keep chip_smoke.py within its budget)
FULL = dict(es_chains=1024, es_iters=(200, 500), es_superchains=32,
            lg_rows=20_000, lg_dim=21, lg_chains=64, lg_iters=(300, 300),
            ch_chains=1024, ch_iters=(500, 500), stream_iters=(500, 1000),
            fault_iters=((100, 75), (75, 50)))
SMALL = dict(es_chains=64, es_iters=(100, 100), es_superchains=8,
             lg_rows=400, lg_dim=3, lg_chains=8, lg_iters=(100, 100),
             ch_chains=32, ch_iters=(150, 150), stream_iters=(100, 200),
             fault_iters=((60, 40), (50, 30)))
REL_TOL_DIAG = 1e-5
REL_TOL_VAG = 1e-5


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _result(check, out, fails):
    return dict(out, check=check, ok=not fails, failures=fails)


def _rel(a, b):
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _timed(dev, fn):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _peak_mb(dev):
    return torch.cuda.max_memory_allocated(dev) / 2 ** 20 if dev.type == "cuda" else None


def simple_ir():
    """The JAX fault-recovery tests' model: mu ~ N(0, 5), six obs ~ N(mu, 0.5)."""
    ys = np.array([2.1, 1.8, 2.5, 2.0, 1.9, 2.3])
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = Builder.rv(ir, "x", dists.Normal, {"mu": "mu", "sigma": 0.5})
    return Builder.obs(ir, "x_obs", "x", ys)


def _logistic_loglik(beta, params, data=None):
    """Bernoulli-logit log-likelihood of the data rows (1, n, d + 1) plus
    the N(0, 2.5) prior, per chain: an empty shard leaves the prior."""
    xm, yv = data[0, :, :-1], data[0, :, -1]
    logits = beta @ xm.T
    ll = torch.sum(yv * logits - torch.nn.functional.softplus(logits), dim=-1)
    return ll + torch.sum(-0.5 * (beta / 2.5) ** 2, dim=-1)


def logistic_data(n=20_000, d=21, seed=0):
    """``scripts/multichip_bench.py::logistic_ir``'s data: (n, d + 1)
    rows of features and the 0/1 outcome."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    beta_true = rng.normal(0, 0.5, size=(d,)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(x @ beta_true)))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    return np.concatenate([x, y[:, None]], axis=1)


def logistic_ir(n=20_000, d=21, seed=0):
    """d-dimensional logistic regression with its rows registered by
    ``Builder.data`` (they split over "sp")."""
    custom = dists.Custom(logpdf_fn=_logistic_loglik, support="real")
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "beta", custom, {}, shape=(d,))
    return Builder.data(ir, logistic_data(n, d, seed))


def gaussian8_ir():
    """``tests/test_chees.py``'s sharded model: x ~ N(0, sds), sds 1..8."""
    with Model() as m:
        m.rv("x", dists.Normal, {"mu": np.zeros(8), "sigma": np.linspace(1.0, 8.0, 8)},
             shape=(8,))
    return m.ir


def example46_ir():
    """Example 46's eight schools: theta a vector of 8."""
    y = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
    sig = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = Builder.rv(ir, "tau", dists.HalfCauchy, {"scale": 5.0})
    ir = Builder.rv(ir, "theta", dists.Normal, {"mu": "mu", "sigma": "tau"}, shape=(8,))
    ir = Builder.rv(ir, "y", dists.Normal,
                    {"mu": "theta", "sigma": np.array(sig, np.float32)}, shape=(8,))
    return Builder.obs(ir, "y_obs", "y", np.array(y, np.float32))


# ---------------------------------------------------------------------------
# The group's checks: every rank runs each, with the same arguments.
# ---------------------------------------------------------------------------

def _diag_parity(x, mesh, k_super):
    """The sharded diagnostics on this rank's rows of the gathered (C, n)
    ``x`` (a device tensor) against the host versions on all of ``x``."""
    axis = mesh.axis("dp")
    loc = torch.as_tensor(x[axis.block(x.shape[0])], device=mesh.device)
    got = {"rhat": float(sharded_rhat(loc, mesh)), "ess": float(sharded_ess(loc, mesh)),
           "nested_rhat": float(sharded_nested_rhat(loc, mesh, k_super))}
    host = {"rhat": float(diag.rhat(x)), "ess": float(diag.ess(x)),
            "nested_rhat": float(diag.nested_rhat(x, k_super))}
    rel = {k: abs(got[k] - host[k]) / abs(host[k]) for k in got}
    return got, host, rel


def check_eight_schools_dp2(rank, mesh, size):
    chains, (warm, draws) = size["es_chains"], size["es_iters"]
    k_super = size["es_superchains"]
    staged0 = mesh.host_staged
    (trace, stats), wall = _timed(mesh.device, lambda: sample_chains_sharded(
        bench.eight_schools_ir(), chains, mesh, seed=1, num_warmup=warm, num_samples=draws,
        pooled_adaptation=True, ensemble_rescue=True, max_tree_depth=10))
    fails = []
    out = {"rank": rank, "chains": chains, "warmup": warm, "draws": draws,
           "ranks": mesh.shape["dp"], "wall_s": wall, "host_syncs": stats["host_syncs"],
           "host_staged_collectives": mesh.host_staged - staged0,
           "peak_mb": _peak_mb(mesh.device)}
    mu, tau = trace["mu"], trace["tau"]
    out.update(mu_mean=float(mu.mean()), tau_mean=float(tau.mean()),
               divergence_rate=float(stats["divergences"].sum()) / (chains * draws),
               rescues=int(stats["rescues"].sum()), chain_ok=bool(stats["chain_ok"].all()),
               redispatched=int(stats["redispatched"]))
    inv = stats["inv_mass"]
    out["inv_mass_equal"] = bool((inv == inv[:1]).all())
    for name, x in (("mu", mu), ("tau", tau)):
        got, host, rel = _diag_parity(x, mesh, k_super)
        out[f"sharded_{name}"] = got
        out[f"host_{name}"] = host
        out[f"rel_{name}"] = max(rel.values())
        if max(rel.values()) > REL_TOL_DIAG:
            fails.append(f"sharded diagnostics of {name} differ from the host's: {rel}")
        if not got["nested_rhat"] < 1.01:
            fails.append(f"nested R-hat {name} {got['nested_rhat']}")
    if abs(out["mu_mean"] - 4.4) >= 0.3:
        fails.append(f"mu {out['mu_mean']}")
    if abs(out["tau_mean"] - 3.6) >= 0.3:
        fails.append(f"tau {out['tau_mean']}")
    if out["divergence_rate"] >= 2e-3:
        fails.append(f"divergence rate {out['divergence_rate']}")
    if not out["inv_mass_equal"]:
        fails.append("inv_mass differs between chains")
    if not out["chain_ok"]:
        fails.append("a chain is not ok")
    return _result("parallel:eight_schools_dp2", out, fails)


def check_logistic_sp2(rank, mesh, size, mesh_dp):
    n, d = size["lg_rows"], size["lg_dim"]
    chains, (warm, draws) = size["lg_chains"], size["lg_iters"]
    ir = logistic_ir(n, d)
    model = compile_logp(ir, device=mesh.device)
    full = model.device_data(ir.data)
    vag = make_data_parallel_vag(model, mesh)
    shard = model.device_data(shard_data(mesh, full))
    q = torch.as_tensor(np.random.default_rng(5).uniform(-0.5, 0.5, size=(8, d)),
                        dtype=torch.float32, device=mesh.device)
    v_sp, g_sp = vag(q, shard)
    v_1, g_1 = model.value_and_grad(q, full)
    rel_v, rel_g = _rel(v_sp.cpu(), v_1.cpu()), _rel(g_sp.cpu(), g_1.cpu())
    fails = []
    if rel_v > REL_TOL_VAG or rel_g > REL_TOL_VAG:
        fails.append(f"data-parallel value/grad differ from one rank's: {rel_v}, {rel_g}")
    staged0 = mesh.host_staged
    (t_sp, st_sp), wall = _timed(mesh.device, lambda: sample_chains_sharded(
        ir, chains, mesh, seed=0, num_warmup=warm, num_samples=draws))
    staged = mesh.host_staged - staged0
    # the sp = 1 reference: a third of the iterations give its means to ~1e-3
    (t_dp, st_dp), wall_dp = _timed(mesh.device, lambda: sample_chains_sharded(
        ir, chains, mesh_dp, seed=0, num_warmup=warm // 3, num_samples=draws // 3))
    m_sp = t_sp["beta"].reshape(-1, d).mean(axis=0)
    m_dp = t_dp["beta"].reshape(-1, d).mean(axis=0)
    out = {"rank": rank, "rows": n, "dim": d, "chains": chains, "warmup": warm,
           "draws": draws, "rel_value": rel_v, "rel_grad": rel_g, "wall_s": wall,
           "sp1_wall_s": wall_dp, "host_syncs": st_sp["host_syncs"],
           "host_staged_collectives": staged,
           "max_mean_diff": float(np.abs(m_sp - m_dp).max()),
           "divergences": int(st_sp["divergences"].sum()),
           "max_rhat": float(max(diag.rhat(t_sp["beta"][:, :, i]) for i in range(d))),
           "peak_mb": _peak_mb(mesh.device)}
    if out["max_mean_diff"] >= 0.1:
        fails.append(f"posterior means differ from sp = 1 by {out['max_mean_diff']}")
    if out["divergences"]:
        fails.append(f"{out['divergences']} divergences")
    return _result("parallel:logistic_sp2", out, fails)


def check_fault_redispatch(rank, mesh, size):
    dev = mesh.device
    fails = []
    faulted = FaultInjector(kind="nan", trigger_lo=0.395, trigger_hi=0.405).wrap_model(
        compile_logp(simple_ir(), device=dev))
    (fw, fd), (rw, rd) = size["fault_iters"]
    trace, stats = sample_chains_sharded(faulted, 8, mesh, num_warmup=fw,
                                         num_samples=fd, seed=1)
    out = {"rank": rank, "fault_chain_ok": bool(stats["chain_ok"].all()),
           "fault_mu": float(trace["mu"].mean()),
           "fault_divergences": int(stats["divergences"].sum())}
    if not (out["fault_chain_ok"] and np.isfinite(trace["mu"]).all()
            and abs(out["fault_mu"] - 2.1) < 0.4):
        fails.append(f"faulted run: {out}")

    model = compile_logp(simple_ir(), device=dev)
    trace, stats = sample_chains_sharded(model, 8, mesh, num_warmup=rw,
                                         num_samples=rd, seed=0, retry_failed=False)
    orig_mu = trace["mu"].copy()
    stats = {k: np.array(v) for k, v in stats.items()}
    trace = {k: np.array(v) for k, v in trace.items()}
    stats["logp"][5] = np.nan  # chain 5 dies after warmup
    trace["mu"][5] = np.nan
    sampler = NUTSSampler(model=model, num_warmup=rw, num_samples=rd)
    trace2, stats2 = _redispatch_failed_chains(sampler, mesh, trace, stats, None,
                                               model.data, seed=0)
    out.update(redispatched=int(stats2["redispatched"]),
               chain_ok=[bool(v) for v in stats2["chain_ok"]],
               retried_mu=float(trace2["mu"][5].mean()),
               untouched_equal=bool(np.array_equal(trace2["mu"][0], orig_mu[0])))
    if not (out["redispatched"] >= 1 and all(out["chain_ok"])
            and np.isfinite(trace2["mu"]).all() and out["untouched_equal"]
            and abs(out["retried_mu"] - 2.1) < 0.4):
        fails.append(f"re-dispatch: {out}")
    return _result("parallel:fault_redispatch", out, fails)


def check_chees_dp2(rank, mesh, size):
    chains, (warm, draws) = size["ch_chains"], size["ch_iters"]
    sds = np.linspace(1.0, 8.0, 8)
    fails, rows = [], []
    for name, fn in (("chees", sample_chees), ("snaper", sample_snaper)):
        staged0 = mesh.host_staged
        (trace, stats), wall = _timed(mesh.device, lambda: fn(
            gaussian8_ir(), num_chains=chains, num_warmup=warm, num_samples=draws,
            seed=2, mesh=mesh))
        staged = mesh.host_staged - staged0
        x = trace["x"]
        row = {"engine": name, "wall_s": wall, "host_syncs": stats["host_syncs"],
               "syncs_per_iter": stats["host_syncs"] / (warm + draws),
               "host_staged_collectives": staged,
               "num_steps_mean": stats["num_steps_mean"],
               "max_rhat": float(max(diag.rhat(x[:, :, i]) for i in range(8))),
               "divergences": int(stats["divergences"].sum()),
               "max_sd_rel_err": float(np.abs(x.reshape(-1, 8).std(axis=0) / sds - 1).max()),
               # under a mesh sample_chees raises on every rank if the
               # ranks' L differed at some iteration
               "L_equal_on_ranks": True,
               "peak_mb": _peak_mb(mesh.device)}
        rows.append(row)
        if not row["max_rhat"] < 1.01:
            fails.append(f"{name}: R-hat {row['max_rhat']}")
        if row["divergences"]:
            fails.append(f"{name}: {row['divergences']} divergences")
        if row["max_sd_rel_err"] >= 0.2:
            fails.append(f"{name}: sd off by {row['max_sd_rel_err']}")
    return _result("parallel:chees_dp2", {"rank": rank, "chains": chains, "warmup": warm,
                                          "draws": draws, "rows": rows}, fails)


def group_main(rank, names, size, device):
    """One rank's run of the group checks ``names``: a list of result
    dicts, each with the fused-leapfrog kernel's launches in this rank
    while it ran."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    mesh = make_mesh(dp=dist.get_world_size(), device=device)
    mesh_sp = make_mesh(dp=1, sp=dist.get_world_size(), device=device)
    lines = []
    for name in names:
        fused_leapfrog_gaussian.launches = 0
        if name == "parallel:logistic_sp2":
            res = check_logistic_sp2(rank, mesh_sp, size, mesh)
        else:
            res = GROUP_CHECKS[name](rank, mesh, size)
        res["fused_leapfrog_gaussian_launches"] = fused_leapfrog_gaussian.launches
        lines.append(res)
    return lines


GROUP_CHECKS = {"parallel:eight_schools_dp2": check_eight_schools_dp2,
                "parallel:fault_redispatch": check_fault_redispatch,
                "parallel:chees_dp2": check_chees_dp2}


# ---------------------------------------------------------------------------
# One rank on NCCL, and the stream check in one process.
# ---------------------------------------------------------------------------

def nccl_main(rank, size, device):
    """``parallel:nccl_world1`` in a one-rank NCCL group."""
    fused_leapfrog_gaussian.launches = 0
    dev = torch.device(device)
    mesh = make_mesh(device=device)
    axis = mesh.axis("dp")
    fails = []
    t = torch.arange(6, dtype=torch.float32, device=dev)
    (s,) = axis.psum(t.clone())
    b = axis.broadcast(t.clone())
    out = {"backend": dist.get_backend(), "tensor_device": str(t.device),
           "collectives_identity": bool(torch.equal(s, t) and torch.equal(b, t))}
    x = np.random.default_rng(3).normal(size=(32, 200)).astype(np.float32)
    xt = torch.as_tensor(x, device=dev)
    rel = {"rhat": abs(float(sharded_rhat(xt, mesh)) / float(diag.rhat(x)) - 1),
           "ess": abs(float(sharded_ess(xt, mesh)) / float(diag.ess(x)) - 1),
           "nested_rhat": abs(float(sharded_nested_rhat(xt, mesh, 8))
                              / float(diag.nested_rhat(x, 8)) - 1)}
    out["diag_rel_err"] = rel
    ir = logistic_ir(size["lg_rows"], size["lg_dim"])
    model = compile_logp(ir, device=dev)
    full = model.device_data(ir.data)
    q = torch.as_tensor(np.random.default_rng(5).uniform(-0.5, 0.5, size=(8, size["lg_dim"])),
                        dtype=torch.float32, device=dev)
    v_sp, g_sp = make_data_parallel_vag(model, make_mesh(dp=1, sp=1, device=device))(q, full)
    v_1, g_1 = model.value_and_grad(q, full)
    out["vag_equal"] = bool(torch.equal(v_sp, v_1) and torch.equal(g_sp, g_1))
    trace, stats = sample_chains_sharded(simple_ir(), 16, mesh, seed=4, num_warmup=100,
                                         num_samples=100, pooled_adaptation=True)
    sampler = NUTSSampler(model=compile_logp(simple_ir(), device=dev), num_warmup=100,
                          num_samples=100, pooled_adaptation=True)
    ref, _ = sampler.run(num_chains=16, seed=4)
    out["sharded_run_equal"] = bool(np.array_equal(trace["mu"], ref["mu"]))
    if not (out["backend"] == "nccl" and out["collectives_identity"]):
        fails.append(f"NCCL collectives on {out['tensor_device']}: {out}")
    if max(rel.values()) > REL_TOL_DIAG:
        fails.append(f"diagnostics differ: {rel}")
    if not out["vag_equal"]:
        fails.append("data-parallel value-and-grad differs from the model's")
    if not out["sharded_run_equal"]:
        fails.append("sharded run differs from the unsharded run")
    res = _result("parallel:nccl_world1", out, fails)
    res["fused_leapfrog_gaussian_launches"] = fused_leapfrog_gaussian.launches
    return [res]


def check_stream_example46(device="cuda", size=FULL):
    """Example 46's stream into a LiveMonitor and a TraceStore, then
    ``phase_report`` and ``annotated_run`` under a profiler trace."""
    dev = torch.device(device)
    warm, draws = size["stream_iters"]
    ir = example46_ir()
    fails = []
    with tempfile.TemporaryDirectory() as tmpdir:
        store = TraceStore(os.path.join(tmpdir, "store"))
        to_store = store.as_callback()
        with open(os.path.join(tmpdir, "frames.txt"), "w", encoding="utf-8") as frames:
            mon = LiveMonitor(num_chains=16, total_draws=draws, params=["mu", "tau"],
                              stream=frames, ansi=False)

            def both(start, trace_chunk, stats_chunk):
                mon(start, trace_chunk, stats_chunk)
                to_store(start, trace_chunk, stats_chunk)

            (trace, _), wall = _timed(dev, lambda: sample_stream(
                ir, both, num_chains=16, chunk_size=100, num_warmup=warm,
                num_samples=draws, seed=0, device=device))
        summary = mon.render_summary()
        reopened = TraceStore.open(store.path)
        out = {"warmup": warm, "draws": draws, "wall_s": wall,
               "mu_mean": float(trace["mu"].mean()),
               "store_chunks": len(reopened._index), "store_draws": reopened.num_samples,
               "store_equal": bool(np.array_equal(reopened.load("mu"), trace["mu"])),
               "summary": summary}
        if abs(out["mu_mean"] - 4.4) >= 1.5:
            fails.append(f"mu {out['mu_mean']}")
        if not (out["store_equal"] and out["store_draws"] == draws):
            fails.append("the trace store does not hold the run's draws")
        if f"streamed {draws} draws x 16 chains" not in summary:
            fails.append(f"monitor summary: {summary!r}")

        report, _ = phase_report(ir, num_chains=16, num_warmup=warm // 10,
                                 num_samples=draws // 20, device=device)
        out["phase_report"] = report
        keys = ("build_and_compile_model_s", "compile_and_first_run_s", "pipeline_run_s",
                "constrain_s", "diagnostics_s", "compile_over_run")
        if any(k not in report for k in keys):
            fails.append(f"phase_report keys: {sorted(report)}")

        logdir = os.path.join(tmpdir, "trace")
        # a short run: the trace of every op and kernel of one iteration
        # holds ~20k events
        sampler = _make_sampler(ir, device=device, num_warmup=3, num_samples=2)
        annotated_run(sampler, num_chains=16, seed=0, logdir=logdir)
        with open(os.path.join(logdir, "trace.json"), encoding="utf-8") as f:
            text = f.read()
        out["trace_mb"] = len(text) / 2 ** 20
        out["trace_kernel_events"] = len(re.findall(r'"cat":\s*"kernel"', text))
        out["trace_spans"] = [s for s in ("exmc:compile+first-run", "exmc:sampling")
                              if f'"{s}"' in text]
        for span in ("exmc:compile+first-run", "exmc:sampling"):
            if span not in out["trace_spans"]:
                fails.append(f"span {span} missing from the profiler trace")
    return _result("stream:example46", out, fails)


def run_task(task, device="cuda"):
    """A single-process task of the pool: a list of result dicts."""
    if task != "stream:example46":
        raise ValueError(f"{task} runs in a group of ranks (start_ranks)")
    return [dict(phase="parallel", **check_stream_example46(device))]


# ---------------------------------------------------------------------------
# Ranks on one host.
# ---------------------------------------------------------------------------

def _rank_entry(rank, fn, world_size, backend, workdir, timeout_s, args):
    # one torch thread: the ranks share the host's cores with each other
    # and with other processes (test workers, the card's pool), and idle
    # OpenMP threads busy-wait
    torch.set_num_threads(1)
    initialize_distributed(f"file://{os.path.join(workdir, 'store')}", world_size,
                           rank, backend=backend, timeout_s=timeout_s)
    try:
        t0 = time.perf_counter()
        out = fn(rank, *args)
        path = os.path.join(workdir, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            torch.save((out, time.perf_counter() - t0), f)
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


class RankRun:
    """The processes of one ``start_ranks`` call; after ``wait``,
    ``seconds`` is the longest rank's wall in ``fn``."""

    def __init__(self, context, workdir, world_size, timeout_s):
        self.context = context
        self.workdir = workdir
        self.world_size = world_size
        self.deadline = time.monotonic() + timeout_s
        self.seconds = None

    def kill(self):
        """Kill every rank still running."""
        for p in self.context.processes:
            if p.is_alive():
                p.kill()
                p.join(10)

    def wait(self):
        """Join every rank by the deadline and return their results in
        rank order. A rank that raised raises here (its peers are
        terminated); at the deadline every rank is killed."""
        try:
            while not self.context.join(timeout=max(self.deadline - time.monotonic(), 0.1)):
                if time.monotonic() >= self.deadline:
                    raise TimeoutError(f"{self.world_size} ranks still running at their "
                                       "deadline")
        finally:
            self.kill()
        out, walls = [], []
        for r in range(self.world_size):
            with open(os.path.join(self.workdir, f"rank{r}.pkl"), "rb") as f:
                res, wall = torch.load(f, weights_only=False)
            out.append(res)
            walls.append(wall)
        self.seconds = max(walls)
        return out


def start_ranks(fn, world_size, args=(), *, workdir, backend="gloo", timeout_s=120.0):
    """Spawn ``world_size`` ranks running ``fn(rank, *args)`` (``fn`` a
    module-level function) in a process group over a ``file://`` store in
    ``workdir``, one torch thread each.
    Returns a ``RankRun``."""
    os.makedirs(workdir, exist_ok=True)
    for name in os.listdir(workdir):
        if name == "store" or name.startswith("rank"):
            os.remove(os.path.join(workdir, name))
    # a fork server imports torch and the package once; each rank is a
    # fork of it, not a fresh interpreter
    multiprocessing.set_forkserver_preload([__name__])
    context = tmp.start_processes(
        _rank_entry, args=(fn, world_size, backend, workdir, timeout_s, args),
        nprocs=world_size, join=False, start_method="forkserver")
    return RankRun(context, workdir, world_size, timeout_s)


def run_ranks(fn, world_size, args=(), **kwargs):
    """``start_ranks(...).wait()``."""
    return start_ranks(fn, world_size, args, **kwargs).wait()


def stop_rank_server():
    """Stop the fork server of ``start_ranks`` and wait for it to exit;
    the next ``start_ranks`` starts another. Left alone it outlives its
    parent by the time it takes to tear down its interpreter (about half
    a second with torch loaded)."""
    multiprocessing.forkserver._forkserver._stop()


def main(argv=None):
    ap = argparse.ArgumentParser(description="Drive the port's parallel package.")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="the tests' small sizes")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    size = SMALL if args.small else FULL
    with tempfile.TemporaryDirectory() as tmpdir:
        try:
            group = start_ranks(group_main, GROUP_SIZE, (GROUP_TASKS, size, args.device),
                                workdir=os.path.join(tmpdir, "group"), timeout_s=args.timeout)
            lines = [dict(phase="parallel", **r) for per_rank in group.wait() for r in per_rank]
            if args.device != "cpu":
                nccl = run_ranks(nccl_main, 1, (size, args.device), backend="nccl",
                                 workdir=os.path.join(tmpdir, "nccl"), timeout_s=args.timeout)
                lines += [dict(phase="parallel", **r) for r in nccl[0]]
        finally:
            stop_rank_server()
        lines.append(dict(phase="parallel", **check_stream_example46(args.device, size)))
    ok = True
    for res in lines:
        ok = ok and res["ok"]
        print(json.dumps(res), flush=True)
    print(json.dumps({"phase": "parallel_summary", "group_seconds": group.seconds}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
