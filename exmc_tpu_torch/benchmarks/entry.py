"""The port's entry points driven end to end on one device: the checks of
the ``entry`` phase of ``chip_smoke.py``. Each check returns one dict
with ``ok``, the list of ``failures`` and what it measured (walls, host
syncs); the tests run them on the CPU at small sizes.

* ``cli``: ``stan_logistic_d21``'s program and its 500 x 21 data written
  as .stan and JSON files, then ``python -m exmc_tpu_torch check``,
  ``sample --output fit.npz`` and ``summary fit.npz`` as subprocesses;
  the fit's beta held to the gold's criterion.
* ``chunked`` and ``stream`` (one run of the model serves both): the
  Stan eight-schools NCP program sampled by ``run``, by ``run_chunked``
  with a checkpoint after every chunk, by a run resumed from the
  checkpoint on disk when the first chunk with draws ends, and by
  ``sample_stream`` in chunks and with ``every``; every run's draws and
  stats bit for bit ``run``'s (256 chains, 60 + 60: cut from 120 + 120
  when the parallel phase joined ``chip_smoke.py``).
* ``data_warm_start``: a conjugate Normal-mean model whose observations
  ride the data channel, fitted on data set A, refitted on B through the
  same cached sampler with ``data=`` and a warm start from A's tuning,
  both against the exact posterior; the refit's value and gradient, and
  its draws, bit for bit a fresh compile's on B; and the suite's ``stress`` model with
  its observations moved to the data channel, sampled with interweave
  and gibbs_scales under the suite's gates.
* ``shared_warmup``: eight schools with chain 0's warmup shared by every
  chain.

    python -m exmc_tpu_torch.benchmarks.entry [check ...] [--device cpu]
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from exmc_tpu_torch import Builder, dists
from exmc_tpu_torch.benchmarks import gold_models, suite
from exmc_tpu_torch.benchmarks.validation import (
    GoldStandard,
    build_golds,
    check_against_reference,
    max_split_rhat,
)
from exmc_tpu_torch.compiler import compile_logp
from exmc_tpu_torch.config import prepare_device
from exmc_tpu_torch.diagnostics import _rhat as rhat
from exmc_tpu_torch.nuts.interweave import eligible_groups
from exmc_tpu_torch.nuts.sampler import (
    _SAMPLER_CACHE,
    _make_sampler,
    sample,
    sample_stream,
)
from exmc_tpu_torch.ops import fused_leapfrog_gaussian

REPO_ROOT = Path(__file__).resolve().parents[2]
SEED = 42


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, dev):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _same(a, b):
    """Bit for bit: the same shape, dtype and bytes."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _same_run(x, y):
    """Two (trace, stats) pairs bit for bit equal, key by key."""
    return all(sorted(p) == sorted(q) and all(_same(p[k], q[k]) for k in p)
               for p, q in zip(x, y))


def _gold_gates(gs, trace):
    """The battery's criterion, max split R-hat < 1.05 and finite draws:
    (failures, worst mean use, max R-hat)."""
    ok, _, worst, _ = check_against_reference(gs, trace)
    rh = max_split_rhat(gs, trace)
    fails = [] if ok else ["moments"]
    if not rh < 1.05:
        fails.append(f"max R-hat {rh:.4f}")
    if not all(np.isfinite(np.asarray(trace[p])).all() for p in gs.ref_means):
        fails.append("non-finite draws")
    return fails, worst, rh


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def check_cli(device="cuda", chains=64, warmup=120, samples=120, gates=True):
    """``check``, ``sample`` and ``summary`` of ``python -m
    exmc_tpu_torch`` on ``stan_logistic_d21`` as subprocesses; with
    ``gates`` the fit's beta meets the gold's criterion."""
    gs = gold_models.stan_logistic_d21()
    data = gold_models.stan_logistic_d21_data()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO_ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out, fails, stdout = {}, [], {}
    with tempfile.TemporaryDirectory() as tmp:
        model, data_file, fit = (os.path.join(tmp, f) for f in
                                 ("logistic.stan", "data.json", "fit.npz"))
        Path(model).write_text(gold_models.STAN_LOGISTIC)
        Path(data_file).write_text(json.dumps(
            {k: v.tolist() if isinstance(v, np.ndarray) else v for k, v in data.items()}))
        commands = {
            "check": ["check", model, "--data", data_file, "--device", str(device)],
            "sample": ["sample", model, "--data", data_file, "--chains", str(chains),
                       "--warmup", str(warmup), "--samples", str(samples),
                       "--seed", str(SEED), "--output", fit, "--device", str(device)],
            "summary": ["summary", fit],
        }
        for name, argv in commands.items():
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "exmc_tpu_torch", *argv],
                                  cwd=REPO_ROOT, env=env, capture_output=True,
                                  text=True, timeout=900)
            out[f"{name}_s"] = time.perf_counter() - t0
            if proc.returncode != 0:
                fails.append(f"{name} exited {proc.returncode}: {proc.stderr[-400:]}")
            stdout[name] = proc.stdout
        if not fails:
            if "unconstrained dimension: 21" not in stdout["check"]:
                fails.append("check did not report dimension 21")
            if "beta[20]" not in stdout["summary"]:
                fails.append("summary lacks beta[20]")
            with np.load(fit) as z:
                beta = z["posterior/beta"]
                n_div = int(z["sample_stats/diverging"].sum())
            out["fit_shape"] = list(beta.shape)
            out["divergences"] = n_div
            if beta.shape != (chains, samples, 21):
                fails.append(f"fit beta has shape {beta.shape}")
            elif gates:
                g, worst, rh = _gold_gates(gs, {"beta": beta})
                fails += g
                out.update(worst_mean_use=worst, max_rhat=rh)
    return dict(out, ok=not fails, failures=fails)


# ---------------------------------------------------------------------------
# chunked, resumed and streamed runs
# ---------------------------------------------------------------------------

def check_chunked_and_stream(device="cuda", chains=256, warmup=60, samples=60,
                             chunk=50, every=10, gates=True):
    """Returns the ``chunked`` and the ``stream`` results: ``run``,
    ``run_chunked`` with a checkpoint, the run resumed from the
    checkpoint on disk when the first chunk with draws ends,
    ``sample_stream`` in chunks of ``chunk`` and with ``every``; all bit
    for bit ``run``'s draws and stats."""
    gs = gold_models.stan_eight_schools_ncp()
    ir, dev = gs.ir, prepare_device(device)
    opts = dict(ncp=gs.ncp, device=dev, num_warmup=warmup, num_samples=samples)
    sampler = _make_sampler(ir, **opts)
    base, run_s = _timed(lambda: sampler.run(num_chains=chains, seed=SEED), dev)
    run_syncs = sampler.last_run["host_syncs"]

    chunked = {"run_s": run_s, "run_host_syncs": run_syncs}
    fails = []
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, first = os.path.join(tmp, "ckpt.npz"), os.path.join(tmp, "first.npz")

        def keep_first(start, trace_chunk, stats_chunk):
            if not os.path.exists(first):
                shutil.copy(ckpt, first)

        ch, chunked["chunked_s"] = _timed(lambda: sampler.run_chunked(
            num_chains=chains, chunk_iters=chunk, seed=SEED, checkpoint_path=ckpt,
            callback=keep_first), dev)
        chunked["chunked_host_syncs"] = sampler.last_run["host_syncs"]
        with np.load(first) as z:
            chunked["resumed_from_iteration"] = int(z["done"])
        res, chunked["resumed_s"] = _timed(lambda: sampler.run_chunked(
            num_chains=chains, chunk_iters=chunk, seed=SEED, resume_from=first), dev)
    chunked["chunked_equal"] = _same_run(base, ch)
    chunked["resumed_equal"] = _same_run(base, res)
    if not chunked["chunked_equal"]:
        fails.append("run_chunked differs from run")
    if not chunked["resumed_equal"]:
        fails.append("the resumed run differs from run")
    if gates:
        g, chunked["worst_mean_use"], chunked["max_rhat"] = _gold_gates(gs, base[0])
        fails += g
    chunked.update(ok=not fails, failures=fails)

    stream = {"run_s": run_s, "run_host_syncs": run_syncs}
    fails = []
    parts = []
    st_chunk, stream["chunked_s"] = _timed(lambda: sample_stream(
        ir, lambda i, tr, st: parts.append((i, tr, st)), num_chains=chains,
        chunk_size=chunk, seed=SEED, **opts), dev)
    stream["chunked_host_syncs"] = sampler.last_run["host_syncs"]
    starts = [p[0] for p in parts]
    glued = ({k: np.concatenate([p[1][k] for p in parts], axis=1) for k in base[0]},
             {k: np.concatenate([p[2][k] for p in parts], axis=1) for k in parts[0][2]})
    stream["chunked_callbacks"] = len(parts)
    stream["chunked_callbacks_equal"] = (
        _same_run((glued[0],), (base[0],))
        # the per-draw stats; a chunk's step_size is per draw, the run's
        # final one per chain
        and all(_same(glued[1][k], base[1][k]) for k in glued[1] if k != "step_size")
        and starts == sorted(starts) and starts[0] == 0)
    stream["chunked_result_equal"] = _same_run(base, st_chunk)

    points = []
    st_every, stream["every_s"] = _timed(lambda: sample_stream(
        ir, lambda i, pt, st: points.append((i, pt)), num_chains=chains, every=every,
        mechanism="io_callback", seed=SEED, **opts), dev)
    stream["every_host_syncs"] = sampler.last_run["host_syncs"]
    stream["every_callbacks"] = len(points)
    want_idx = list(range(every - 1, samples, every))
    stream["every_callbacks_equal"] = (
        [p[0] for p in points] == want_idx
        and all(_same(pt[k], base[0][k][:, i]) for i, pt in points for k in base[0]))
    stream["every_result_equal"] = _same_run(base, st_every)
    stream["every_extra_syncs"] = stream["every_host_syncs"] - run_syncs
    for key in ("chunked_callbacks_equal", "chunked_result_equal",
                "every_callbacks_equal", "every_result_equal"):
        if not stream[key]:
            fails.append(key.replace("_", " ") + " is False")
    if stream["every_extra_syncs"] != len(want_idx):
        fails.append(f"every={every} added {stream['every_extra_syncs']} host syncs, "
                     f"expected one per callback ({len(want_idx)})")
    stream.update(ok=not fails, failures=fails)
    return chunked, stream


# ---------------------------------------------------------------------------
# runtime data channel and warm start
# ---------------------------------------------------------------------------

PRIOR_SD, OBS_SD = 10.0, 2.0


def conjugate_channel_ir(y):
    """mu ~ N(0, PRIOR_SD); y_i ~ N(mu, OBS_SD), the observations read
    from the data channel (``Builder.data`` + ``"__obs_data"``)."""
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": PRIOR_SD})
    ir = Builder.rv(ir, "y", dists.Normal, {"mu": "mu", "sigma": OBS_SD},
                    shape=(len(y),))
    ir = Builder.obs(ir, "y_obs", "y", "__obs_data", reduce="sum")
    return Builder.data(ir, np.asarray(y, np.float32))


def conjugate_target(y, name):
    y = np.asarray(y, np.float32).astype(np.float64)
    var = 1.0 / (1.0 / PRIOR_SD**2 + len(y) / OBS_SD**2)
    return GoldStandard(name, None, {"mu": var * y.sum() / OBS_SD**2},
                        {"mu": float(np.sqrt(var))})


def channel_ir(ir):
    """``ir`` with every inline observation value moved to keyed data:
    obs ``k`` reads ``("__obs_data", k)``."""
    data = {}
    for nid, node in ir.nodes.items():
        if node.op[0] == "obs":
            tag, rv_id, value, meta = node.op
            data[nid] = np.asarray(value, np.float32)
            ir = ir.replace_node(replace(node, op=(tag, rv_id, ("__obs_data", nid), meta)))
    return Builder.data(ir, data)


def check_data_warm_start(device="cuda", chains=256, warmup=120, samples=120,
                          n_obs=100_000, n_points=8, stress_chains=None, gates=True):
    """Fit on A, refit on B through the same cached sampler (``data=B``,
    warm start from A's tuning); the refit's value-and-grad at
    ``n_points`` and its draws and stats against a fresh compile on B,
    bit for bit; then the channel-fed stress model under interweave and
    gibbs_scales."""
    dev = prepare_device(device)
    rng = np.random.default_rng(2024)
    y_a = rng.normal(1.5, OBS_SD, n_obs).astype(np.float32)
    y_b = rng.normal(-0.7, OBS_SD, n_obs).astype(np.float32)
    ir_a = conjugate_channel_ir(y_a)
    opts = dict(device=dev, num_warmup=warmup, num_samples=samples)
    out, fails = {}, []
    (tr_a, st_a), out["fit_a_s"] = _timed(
        lambda: sample(ir_a, num_chains=chains, seed=SEED, **opts), dev)
    sampler = _make_sampler(ir_a, **opts)
    out["fit_a_host_syncs"] = sampler.last_run["host_syncs"]
    n_cached = len(_SAMPLER_CACHE)
    warm = {"step_size": st_a["step_size"], "inv_mass": st_a["inv_mass"]}
    (tr_b, st_b), out["refit_b_s"] = _timed(
        lambda: sample(ir_a, num_chains=chains, seed=SEED + 1, data=y_b,
                       warm_start=warm, **opts), dev)
    out["refit_b_host_syncs"] = sampler.last_run["host_syncs"]
    out["refit_b_iterations"] = sampler.last_run["iterations"]
    out["same_cached_sampler"] = (len(_SAMPLER_CACHE) == n_cached and _make_sampler(
        conjugate_channel_ir(y_b), **opts) is sampler)
    if not out["same_cached_sampler"]:
        fails.append("the refit did not reuse the cached sampler")

    # the refit's value-and-grad, replayed after A's data filled the
    # buffers, against a fresh compile on B (its data captured as
    # constants)
    x = torch.as_tensor(np.random.default_rng(1).normal(
        float(tr_b["mu"].mean()), 0.05, size=(n_points, 1)), dtype=torch.float32,
        device=dev)
    model = sampler.model
    lp_a, _ = model.value_and_grad(x, model.device_data(y_a))
    lp_b, g_b = model.value_and_grad(x, model.device_data(y_b))
    fresh = compile_logp(conjugate_channel_ir(y_b), device=dev)
    lp_f, g_f = fresh.value_and_grad(x)
    out["refit_vag_bit_equal"] = bool(torch.equal(lp_b, lp_f) and torch.equal(g_b, g_f))
    out["refit_vag_moved_from_a"] = bool(not torch.equal(lp_a, lp_b))
    if not (out["refit_vag_bit_equal"] and out["refit_vag_moved_from_a"]):
        fails.append("the refit's value-and-grad differs from a fresh compile on B")
    # and the whole refit: a fresh sampler on B, the same warm start and seed
    refit_fresh = _make_sampler(fresh, num_warmup=warmup, num_samples=samples).run(
        num_chains=chains, seed=SEED + 1, warm_start=warm)
    out["refit_bit_equal_fresh"] = _same_run((tr_b, st_b), refit_fresh)
    if not out["refit_bit_equal_fresh"]:
        fails.append("the refit's draws differ from a fresh sampler's on B")

    if gates:
        for tag, tr, y in (("a", tr_a, y_a), ("b", tr_b, y_b)):
            g, out[f"worst_mean_use_{tag}"], out[f"max_rhat_{tag}"] = _gold_gates(
                conjugate_target(y, f"conjugate_{tag}"), tr)
            fails += [f"data set {tag.upper()}: {m}" for m in g]
        out["mu_mean"] = [float(tr_a["mu"].mean()), float(tr_b["mu"].mean())]

    # the stress model with its observations on the data channel
    recipe = suite.SUITE_RECIPE["stress"]
    ir_s = channel_ir(suite.stress_model())
    smp = _make_sampler(ir_s, ncp=recipe["ncp"], device=dev, num_warmup=warmup,
                        num_samples=samples, **recipe["opts"])
    groups = eligible_groups(smp.model)
    out["stress_channel_groups"] = sum(
        any(s[0] == "data" for s in _obs_specs(g)) for g in groups)
    c = recipe["chains"] if stress_chains is None else stress_chains
    (tr_s, st_s), out["stress_s"] = _timed(
        lambda: sample(ir_s, num_chains=c, seed=SEED, ncp=recipe["ncp"], device=dev,
                       num_warmup=warmup, num_samples=samples, **recipe["opts"]), dev)
    out["stress_host_syncs"] = smp.last_run["host_syncs"]
    out["stress_iw_accept"] = float(st_s["iw_accept"].mean())
    if out["stress_channel_groups"] == 0:
        fails.append("no interweave group of the stress model reads the channel")
    if gates:
        res = {"all_finite": bool(all(np.isfinite(v).all() for v in tr_s.values())),
               "max_rhat": max(float(rhat(v.reshape(v.shape[0], v.shape[1], -1)[:, :, i]))
                               for v in tr_s.values()
                               for i in range(int(np.prod(v.shape[2:])))),
               "divergence_rate": float(st_s["divergences"].sum()) / (c * samples),
               "posterior": suite.posterior_summary("stress", tr_s)}
        out["stress_max_rhat"] = res["max_rhat"]
        fails += [f"stress on the channel: {m}" for m in suite.gate_failures("stress", res)]
    return dict(out, ok=not fails, failures=fails)


def _obs_specs(group):
    """The obs y specs of an interweave group: its obs-noise latents' and
    its ancillary legs'."""
    specs = [z[3][1] for z in group["zs"] if z[2] == "obs_noise"]
    return specs + [y for a in group["anc"] or () for y, _ in a[3]]


# ---------------------------------------------------------------------------
# shared warmup
# ---------------------------------------------------------------------------

def check_shared_warmup(device="cuda", chains=64, warmup=120, samples=120, gates=True):
    """Eight schools (the core gold) with ``shared_warmup=True``: one step
    size and one metric for every chain, and the gold's criterion."""
    gs = build_golds(["eight_schools_ncp"])["eight_schools_ncp"]
    dev = prepare_device(device)
    sampler = _make_sampler(gs.ir, ncp=gs.ncp, device=dev, num_warmup=warmup,
                            num_samples=samples, shared_warmup=True)
    (tr, st), wall = _timed(lambda: sampler.run(num_chains=chains, seed=SEED), dev)
    out = {"s": wall, "host_syncs": sampler.last_run["host_syncs"],
           "step_size": float(st["step_size"][0])}
    fails = []
    out["one_step_size"] = bool(np.all(st["step_size"] == st["step_size"][0]))
    out["one_metric"] = bool(np.all(st["inv_mass"] == st["inv_mass"][:1]))
    if not (out["one_step_size"] and out["one_metric"]):
        fails.append("the chains do not share one step size and metric")
    if gates:
        g, out["worst_mean_use"], out["max_rhat"] = _gold_gates(gs, tr)
        fails += g
    return dict(out, ok=not fails, failures=fails)


# ---------------------------------------------------------------------------

def run_check(name, device="cuda", **kw):
    """One task of the entry phase: a list of result dicts, one per
    check, each with its seconds and the fused-leapfrog kernel's
    launches during the task (on the first)."""
    fused_leapfrog_gaussian.launches = 0
    t0 = time.perf_counter()
    if name == "chunked_stream":
        results = list(check_chunked_and_stream(device, **kw))
        names = ["chunked", "stream"]
    else:
        results = [CHECKS[name](device, **kw)]
        names = [name]
    seconds = time.perf_counter() - t0
    launches = fused_leapfrog_gaussian.launches
    return [dict({"check": n, "task_seconds": seconds,
                  "fused_leapfrog_gaussian_launches": launches if i == 0 else 0}, **r)
            for i, (n, r) in enumerate(zip(names, results))]


CHECKS = {
    "cli": check_cli,
    "data_warm_start": check_data_warm_start,
    "shared_warmup": check_shared_warmup,
}
TASKS = ["chunked_stream", "data_warm_start", "cli", "shared_warmup"]


def main(argv=None):
    ap = argparse.ArgumentParser(description="Drive the port's entry points.")
    ap.add_argument("tasks", nargs="*", help=f"of {TASKS} (default: all)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    unknown = set(args.tasks) - set(TASKS)
    if unknown:
        ap.error(f"unknown tasks {sorted(unknown)}")
    ok = True
    for task in args.tasks or TASKS:
        for res in run_check(task, args.device):
            ok = ok and res["ok"]
            print(json.dumps(res), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
