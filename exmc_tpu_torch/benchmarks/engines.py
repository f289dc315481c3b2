"""The ensemble engines and the approximate engines driven on one device:
the ``engines`` and ``vi`` phases of ``chip_smoke.py`` (after the JAX
package's ``scripts/chees_bench.py`` and ``benchmarks/entry.py``). Each
check returns one dict with ``ok``, the list of ``failures`` and what it
measured; the tests run them on the CPU at small sizes.

* ``engine`` runs (``run_engine``): ChEES, SNAPER and MEADS on the three
  ``chees_bench`` models (``scaled32``: 32-d Gaussian, sds 1..10;
  ``corrblock128``: 128-d MvNormal with an 8-d rho = 0.97 block;
  ``eight_schools``: the NCP headline model), 1024 chains, 500 warmup +
  500 draws: a short run that captures the model's graphs, then the
  timed seed-1 run. Gates where the JAX package's own runs converge
  (every ChEES and SNAPER row, MEADS on scaled32): max split R-hat <
  1.05, finite draws, divergence rate < 5e-3; each coordinate's mean
  within 4 MCSE of 0 and its sd within 10 % of the analytic sd
  (scaled32, corrblock128); mu 4.4 ± 0.3 and tau 3.6 ± 0.3 (eight
  schools). MEADS on corrblock128 and eight schools does not converge in
  the JAX package's runs (CHEES_BENCH.json: R-hat 1.43-1.56), so those
  two rows are held to finite draws only. ``run_nuts`` runs the port's
  NUTS (pooled adaptation) on the same model and chain count.
* ``approx`` (``check_approx``) on the gold ``stan_logistic_d21`` (N =
  500, K = 21): the CLI's ``optimize`` and ``variational`` (Adam, 5000
  steps) as subprocesses; ``fit_map`` with both ``jacobian`` settings
  and ``seed=None`` on the device and on the CPU (equal to 1e-4 of
  max(1, |x|)); ``laplace(psir=True)``; ``advi_fit`` with SGD and Adam;
  ``pathfinder_fit`` diag, lowrank and lowrank + PSIR; each held to the
  JAX package's own result on this model (``APPROX_REFERENCES``, from
  ``tests/test_torch_engines_refs.py``), with the tolerances stated there.
* ``pathfinder_init`` (``check_pathfinder_init``): NUTS on the Stan
  eight-schools NCP program at 256 chains x 120+120 from
  ``init="pathfinder"``, held to the entry checks' posterior gate, with
  the Pathfinder init's wall apart.

    python -m exmc_tpu_torch.benchmarks.engines [task ...] [--device cpu] [--nuts]

where a task is ``<model>:<engine>`` (e.g. ``eight_schools:chees``),
``approx`` or ``pathfinder_init``; ``--nuts`` then runs the port's NUTS
once on each model of the engine tasks, for comparison.
"""

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from exmc_tpu_torch import Builder, bench, dists
from exmc_tpu_torch.advi import advi_fit
from exmc_tpu_torch.benchmarks import gold_models
from exmc_tpu_torch.benchmarks.entry import REPO_ROOT, SEED, _gold_gates, _timed
from exmc_tpu_torch.benchmarks.validation import check_against_reference
from exmc_tpu_torch.chees import sample_chees
from exmc_tpu_torch.compiler import compile_logp
from exmc_tpu_torch.config import prepare_device
from exmc_tpu_torch.diagnostics import _ess as ess, _rhat as rhat
from exmc_tpu_torch.meads import sample_meads
from exmc_tpu_torch.nuts.sampler import _make_sampler
from exmc_tpu_torch.optimize import fit_map, laplace
from exmc_tpu_torch.pathfinder import pathfinder_fit, pathfinder_init
from exmc_tpu_torch.stan import frontend as stan

ENGINES = ("chees", "snaper", "meads")
CHAINS, WARMUP, DRAWS = 1024, 500, 500
WARM_RUN = (10, 10)  # the graph-capturing run's warmup and draws
# (model, engine) rows that do not converge in the JAX package's runs
FINITE_ONLY = {("corrblock128", "meads"), ("eight_schools", "meads")}


def scaled32_ir():
    """32-d Gaussian with sds 1..10: trajectory length matters."""
    return Builder.rv(Builder.new_ir(), "x", dists.Normal,
                      {"mu": np.zeros(32), "sigma": np.linspace(1.0, 10.0, 32)},
                      shape=(32,))


def corrblock128_cov():
    d, k, rho = 128, 8, 0.97
    cov = np.eye(d)
    cov[:k, :k] = np.full((k, k), rho) + (1.0 - rho) * np.eye(k)
    return cov


def corrblock128_ir():
    """128-d MvNormal: one 8-d rho = 0.97 block in 120 iid unit dims (the
    SNAPER-against-ChEES separator)."""
    return Builder.rv(Builder.new_ir(), "x", dists.MvNormal,
                      {"mu": np.zeros(128), "cov": corrblock128_cov()})


MODELS = {"scaled32": scaled32_ir, "corrblock128": corrblock128_ir,
          "eight_schools": bench.eight_schools_ir}
ANALYTIC_SD = {"scaled32": np.linspace(1.0, 10.0, 32), "corrblock128": np.ones(128)}
TASKS = [f"{m}:{e}" for m in MODELS for e in ENGINES] + ["approx", "pathfinder_init"]


def _coords(trace):
    """(chains, draws) columns of every scalar coordinate of a trace."""
    out = {}
    for k, v in trace.items():
        a = np.asarray(v)
        flat = a.reshape(a.shape[0], a.shape[1], -1)
        for i in range(flat.shape[-1]):
            out[k if flat.shape[-1] == 1 and a.ndim == 2 else f"{k}[{i}]"] = flat[:, :, i]
    return out


def _summary(trace, stats, wall, iters):
    """min ESS, ESS/s, max split R-hat, divergence rate, finite draws and
    the per-coordinate moments (with their MCSE)."""
    cols = _coords(trace)
    ess_c = {k: float(ess(v)) for k, v in cols.items()}
    rhat_c = {k: float(rhat(v)) for k, v in cols.items()}
    div = np.asarray(stats["diverging"])
    min_ess = min(ess_c.values())
    return {
        "wall_s": wall, "min_ess": min_ess, "min_ess_per_s": min_ess / wall,
        "max_rhat": max(rhat_c.values()),
        "divergence_rate": float(div.mean()),
        "finite": bool(all(np.isfinite(v).all() for v in cols.values())),
        "syncs_per_iter": stats.get("host_syncs", 0) / iters,
        "means": {k: float(v.mean()) for k, v in cols.items()},
        "sds": {k: float(v.std()) for k, v in cols.items()},
        "mcse": {k: float(v.std()) / math.sqrt(max(ess_c[k], 1.0)) for k, v in cols.items()},
    }


def gate_failures(name, engine, s):
    """The engine row's gates (module docstring)."""
    fails = [] if s["finite"] else ["non-finite draws"]
    if (name, engine) in FINITE_ONLY:
        return fails
    if not s["max_rhat"] < 1.05:
        fails.append(f"max R-hat {s['max_rhat']:.4f}")
    if not s["divergence_rate"] < 5e-3:
        fails.append(f"divergence rate {s['divergence_rate']:.4g}")
    if name in ANALYTIC_SD:
        keys = sorted(s["means"], key=lambda k: int(k.split("[")[1][:-1]))
        means = np.array([s["means"][k] for k in keys])
        mcse = np.array([s["mcse"][k] for k in keys])
        sds = np.array([s["sds"][k] for k in keys])
        bad_mean = np.nonzero(np.abs(means) > 4 * mcse)[0]
        bad_sd = np.nonzero(np.abs(sds / ANALYTIC_SD[name] - 1.0) > 0.1)[0]
        if bad_mean.size:
            fails.append(f"means beyond 4 MCSE of 0 at {bad_mean.tolist()}")
        if bad_sd.size:
            fails.append(f"sds off by > 10 % at {bad_sd.tolist()}")
    else:
        for p, want in (("mu", 4.4), ("tau", 3.6)):
            if not abs(s["means"][p] - want) < 0.3:
                fails.append(f"{p} mean {s['means'][p]:.3f} not within 0.3 of {want}")
    return fails


def _engine_fn(engine):
    if engine == "meads":
        return lambda model, **kw: sample_meads(model, **kw)
    return lambda model, **kw: sample_chees(model, criterion=engine, **kw)


def _peak_reset(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_mb(dev):
    return torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda" else None


def run_engine(name, engine, device="cuda", chains=CHAINS, warmup=WARMUP, draws=DRAWS,
               warm_run=WARM_RUN):
    """One engine row: the graph-capturing run (seed 0), then the timed
    seed-1 run on the same compiled model, with its summary and gates.
    MEADS's Pathfinder-fallback warning fails the row."""
    dev = prepare_device(device)
    model = compile_logp(MODELS[name](), device=dev)
    fn = _engine_fn(engine)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, first_s = _timed(lambda: fn(model, num_chains=chains, num_warmup=warm_run[0],
                                       num_samples=warm_run[1], seed=0), dev)
        _peak_reset(dev)
        (trace, stats), wall = _timed(lambda: fn(model, num_chains=chains,
                                                 num_warmup=warmup, num_samples=draws,
                                                 seed=1), dev)
    s = _summary(trace, stats, wall, warmup + draws)
    out = {"model": name, "engine": engine, "chains": chains, "warmup": warmup,
           "draws": draws, "d": model.size, "first_run_s": first_s,
           **{k: v for k, v in s.items() if k not in ("means", "sds", "mcse")},
           "num_steps_mean": stats.get("num_steps_mean"),
           "step_size": np.asarray(stats["step_size"]).tolist(),
           "peak_mb": _peak_mb(dev)}
    if name == "eight_schools":
        out.update(mu_mean=s["means"]["mu"], tau_mean=s["means"]["tau"])
    fails = gate_failures(name, engine, s)
    fallback = [str(w.message) for w in caught if "init='pathfinder'" in str(w.message)]
    if fallback:
        fails.append(f"MEADS fell back from the Pathfinder init: {fallback[0][:200]}")
    return dict(out, gated=(name, engine) not in FINITE_ONLY, ok=not fails, failures=fails)


def run_nuts(name, device="cuda", chains=CHAINS, warmup=WARMUP, draws=DRAWS,
             warm_run=WARM_RUN):
    """The port's NUTS (pooled adaptation, as ``chees_bench`` runs it) on
    the same model and chain count, for comparison."""
    dev = prepare_device(device)
    model = compile_logp(MODELS[name](), device=dev)
    _make_sampler(model, num_warmup=warm_run[0], num_samples=warm_run[1],
                  pooled_adaptation=True).run(num_chains=chains, seed=0)
    sampler = _make_sampler(model, num_warmup=warmup, num_samples=draws,
                            pooled_adaptation=True)
    _peak_reset(dev)
    (trace, stats), wall = _timed(lambda: sampler.run(num_chains=chains, seed=1), dev)
    stats["host_syncs"] = sampler.last_run["host_syncs"]
    s = _summary(trace, stats, wall, warmup + draws)
    return {"model": name, "engine": "nuts", "chains": chains, "warmup": warmup,
            "draws": draws, **{k: v for k, v in s.items() if k not in ("means", "sds", "mcse")},
            "mean_depth": float(np.asarray(stats["depth"]).mean()),
            "peak_mb": _peak_mb(dev)}


# ---------------------------------------------------------------------------
# approximate engines on stan_logistic_d21
# ---------------------------------------------------------------------------

# The JAX package's own results on stan_logistic_d21 on the CPU (same
# model, same options), from ``tests/test_torch_engines_refs.py``.
APPROX_REFERENCES = {'map_beta': [0.686074, -0.332421, 0.289122, 1.0903, -0.176398, 0.213535, -0.212928,
                                  0.328718, -0.3983, 0.752366, 0.210547, 0.190697, 0.0242306, -0.810893,
                                  0.546173, 0.243106, -0.590039, 0.435831, -0.977249, 0.111134,
                                  0.716056],
                     'laplace_cov_logdet': -87.26142120361328,
                     'laplace_pareto_k': 0.43006158049164245,
                     'laplace_ess_is': 536.6395253482875,
                     'advi_mu_tol_sd': 2.0,
                     'advi_sigma_tol': 1.4,
                     'advi_sgd': {'mu': [0.74409, -0.363827, 0.306571, 1.1775, -0.103355, 0.312491,
                                         -0.202494, 0.408311, -0.390037, 0.848355, 0.302103, 0.131305,
                                         0.0252776, -0.881433, 0.540455, 0.297505, -0.533407, 0.40542,
                                         -1.05454, 0.0961048, 0.69265],
                                  'sigma': [0.142075, 0.133167, 0.13551, 0.14627, 0.128698, 0.129433,
                                            0.128135, 0.131518, 0.126775, 0.142736, 0.132038, 0.138253,
                                            0.1291, 0.148752, 0.146711, 0.141721, 0.126441, 0.141721,
                                            0.144859, 0.13593, 0.132551],
                                  'steps_run': 600},
                     'advi_adam': {'mu': [0.729246, -0.400699, 0.285381, 1.13718, -0.1489, 0.186071,
                                          -0.20259, 0.391893, -0.416292, 0.809791, 0.243777, 0.1594,
                                          0.033798, -0.901191, 0.545192, 0.290136, -0.558978, 0.442288,
                                          -1.04487, 0.100701, 0.741652],
                                   'sigma': [0.134649, 0.128422, 0.125079, 0.141521, 0.120661, 0.12452,
                                             0.119873, 0.125541, 0.123965, 0.137229, 0.12491, 0.132785,
                                             0.119874, 0.143783, 0.14085, 0.131572, 0.121532, 0.138599,
                                             0.135022, 0.12077, 0.125103],
                                   'steps_run': 600},
                     'pathfinder_diag_best_elbo_range': [-581.896, -385.733],
                     'pathfinder_lowrank_best_elbo_range': [-1785.997, -909.168]}


def _stan_logistic():
    data = gold_models.stan_logistic_d21_data()
    return gold_models.STAN_LOGISTIC, data


def _cli(argv, tmp):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO_ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "exmc_tpu_torch", *argv], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True, timeout=900)
    return proc, time.perf_counter() - t0


def check_cli_approx(device="cuda", iters=5000):
    """``optimize`` and ``variational`` as subprocesses on the device: the
    MAP report (converged, beta[0] near the JAX MAP's) and the ADVI fit
    file."""
    code, data = _stan_logistic()
    out, fails = {}, []
    ref = APPROX_REFERENCES["map_beta"]
    with tempfile.TemporaryDirectory() as tmp:
        model, data_file, fit = (os.path.join(tmp, f) for f in
                                 ("logistic.stan", "data.json", "advi.npz"))
        Path(model).write_text(code)
        Path(data_file).write_text(json.dumps(
            {k: v.tolist() if isinstance(v, np.ndarray) else v for k, v in data.items()}))
        proc, out["optimize_s"] = _cli(["optimize", model, "--data", data_file,
                                        "--device", str(device)], tmp)
        if proc.returncode != 0:
            fails.append(f"optimize exited {proc.returncode}: {proc.stderr[-400:]}")
        else:
            report = proc.stdout.strip()
            out["optimize_report"] = report.splitlines()[0]
            beta = np.array(re.findall(r"-?\d+\.\d*(?:e-?\d+)?",
                                       report.split("beta", 1)[1]), float)
            if not (report.startswith("MAP (converged") and beta.shape == (21,)
                    and _near(beta, ref, 1e-3)):
                fails.append(f"optimize report: {report[:300]}")
        proc, out["variational_s"] = _cli(["variational", model, "--data", data_file,
                                           "--iters", str(iters), "--seed", str(SEED),
                                           "--output", fit, "--device", str(device)], tmp)
        if proc.returncode != 0:
            fails.append(f"variational exited {proc.returncode}: {proc.stderr[-400:]}")
        else:
            out["variational_report"] = proc.stdout.strip().splitlines()[0]
            with np.load(fit) as z:
                beta = z["posterior/beta"]
            out["variational_fit_shape"] = list(beta.shape)
            if beta.shape != (1, 1000, 21) or not np.isfinite(beta).all():
                fails.append(f"variational fit has shape {beta.shape}")
    return dict(out, ok=not fails, failures=fails)


def _near(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return bool(np.all(np.abs(got - want) <= tol * np.maximum(1.0, np.abs(want))))


def check_approx(device="cuda", advi_steps=5000, pf_iters=100, draws=1000):
    """The library calls on stan_logistic_d21 (module docstring), each a
    dict with its wall and gates."""
    dev = prepare_device(device)
    ref = APPROX_REFERENCES
    code, data = _stan_logistic()
    gs = gold_models.stan_logistic_d21()
    model = compile_logp(stan.compile(code, data), ncp=False, device=dev)
    cpu = compile_logp(stan.compile(code, data), ncp=False, device="cpu")
    rows = []

    def row(name, fn, gates):
        res, wall = _timed(fn, dev)
        out, fails = gates(res)
        rows.append(dict({"check": name, "s": wall}, **out, ok=not fails, failures=fails))

    for jac, seed in ((True, SEED), (False, SEED), (True, None)):
        def gates(res, jac=jac, seed=seed):
            (point, info) = res
            _, cinfo = fit_map(cpu, seed=seed, jacobian=jac)
            same = _near(info["z_map"], cinfo["z_map"], 1e-4)
            fails = [] if info["converged"] else ["not converged"]
            if not same:
                fails.append("the device's MAP differs from the CPU's")
            if not _near(point["beta"], ref["map_beta"], 1e-3):
                fails.append("MAP differs from the JAX package's")
            return {"jacobian": jac, "seed": seed, "iters": info["iters"],
                    "cpu_iters": cinfo["iters"], "host_syncs": info["host_syncs"],
                    "equal_to_cpu": same,
                    "max_abs_err_vs_cpu": float(np.abs(info["z_map"] - cinfo["z_map"]).max())
                    }, fails
        row(f"fit_map(jacobian={jac}, seed={seed})",
            lambda jac=jac, seed=seed: fit_map(model, seed=seed, jacobian=jac), gates)

    def lap_gates(res):
        trace, info = res
        ok, _, worst, (lo, hi) = check_against_reference(gs, trace)
        p = info["psir"]
        fails = [] if ok else ["the battery's criterion"]
        if not abs(info["cov_logdet"] - ref["laplace_cov_logdet"]) < 1e-3 * abs(
                ref["laplace_cov_logdet"]):
            fails.append(f"cov_logdet {info['cov_logdet']}")
        if not (p["pareto_k"] < 0.7 and p["ess_is"] > 0.25 * draws):
            fails.append(f"PSIR k-hat {p['pareto_k']:.3f}, ESS_IS {p['ess_is']:.0f}")
        return {"cov_logdet": info["cov_logdet"], "pareto_k": p["pareto_k"],
                "ess_is": p["ess_is"], "worst_mean_use": worst,
                "sd_ratio_range": [lo, hi]}, fails
    row("laplace(psir=True)", lambda: laplace(model, seed=SEED, draws=draws, psir=True),
        lap_gates)

    for opt in ("sgd", "adam"):
        def advi_gates(fit, opt=opt):
            r = ref[f"advi_{opt}"]
            mu_use = float(np.max(np.abs(fit["mu"] - np.asarray(r["mu"]))
                                  / np.asarray(r["sigma"])))
            ratio = fit["sigma"] / np.asarray(r["sigma"])
            ok, _, worst, (lo, hi) = check_against_reference(gs, fit["draws"])
            fails = []
            if not mu_use < ref["advi_mu_tol_sd"]:
                fails.append(f"mu off JAX's by {mu_use:.2f} sd")
            if not np.all((ratio > 1 / ref["advi_sigma_tol"]) & (ratio < ref["advi_sigma_tol"])):
                fails.append(f"sigma ratio {ratio.min():.3f}-{ratio.max():.3f}")
            return {"optimizer": opt, "steps_run": fit["steps_run"],
                    "converged_at": fit["converged_at"], "host_syncs": fit["host_syncs"],
                    "mu_off_jax_sd": mu_use, "sigma_ratio_range": [float(ratio.min()),
                                                                  float(ratio.max())],
                    "worst_mean_use": worst, "sd_ratio_range": [lo, hi],
                    "meets_battery_criterion": ok}, fails
        row(f"advi_fit({opt})", lambda opt=opt: advi_fit(
            model, num_steps=advi_steps, seed=SEED, optimizer=opt, num_draws=draws),
            advi_gates)

    for method, psir in (("diag", False), ("lowrank", False), ("lowrank", True)):
        def pf_gates(fit, method=method, psir=psir):
            lo_e, hi_e = ref[f"pathfinder_{method}_best_elbo_range"]
            best = float(np.max(fit["elbo_path"]))
            pad = 0.25 * abs(hi_e - lo_e) + 1.0
            fails = [] if lo_e - pad <= best <= hi_e + pad else [f"best ELBO {best:.1f}"]
            out = {"method": method, "psir": psir, "best_iter": fit["best_iter"],
                   "best_elbo": best, "sigma_range": [float(fit["sigma"].min()),
                                                      float(fit["sigma"].max())]}
            if method == "lowrank":
                # the JAX package's lowrank path never leaves its start on
                # this model (the first step's gradient is NaN): alpha = 1
                stuck = bool(np.all(fit["sigma"] == 1.0))
                out["stuck_at_start_as_jax"] = stuck
                if not stuck:
                    fails.append("lowrank moved where the JAX package's does not")
            if psir:
                p = fit["psir"]
                out.update(pareto_k=p["pareto_k"], ess_is=p["ess_is"])
                if not p["pareto_k"] > 0.7:
                    fails.append(f"k-hat {p['pareto_k']:.3f} does not flag the fit, "
                                 "as the JAX package's does")
            if not np.isfinite(fit["draws_unconstrained"]).all():
                fails.append("non-finite draws")
            return out, fails
        row(f"pathfinder_fit({method}{', psir' if psir else ''})",
            lambda method=method, psir=psir: pathfinder_fit(
                model, num_iters=pf_iters, num_draws=draws, seed=SEED, method=method,
                psir=psir), pf_gates)
    return rows


def check_pathfinder_init(device="cuda", chains=256, warmup=120, samples=120,
                          gates=True):
    """NUTS from ``init="pathfinder"`` on the Stan eight-schools NCP
    program, held to the gold's criterion; the Pathfinder init timed
    apart (it makes one host decision per path, the best iteration)."""
    gs = gold_models.stan_eight_schools_ncp()
    dev = prepare_device(device)
    sampler = _make_sampler(gs.ir, ncp=gs.ncp, device=dev, num_warmup=warmup,
                            num_samples=samples)
    q, pf_s = _timed(lambda: pathfinder_init(sampler.model, chains, seed=SEED), dev)
    (tr, st), wall = _timed(lambda: sampler.run(num_chains=chains, seed=SEED,
                                                init="pathfinder"), dev)
    out = {"pathfinder_init_s": pf_s, "run_s": wall,
           "run_host_syncs": sampler.last_run["host_syncs"],
           "init_spread": float(np.std(q, axis=0).mean())}
    fails = [] if np.isfinite(q).all() else ["non-finite Pathfinder inits"]
    if gates:
        g, out["worst_mean_use"], out["max_rhat"] = _gold_gates(gs, tr)
        fails += g
    return dict(out, ok=not fails, failures=fails)


def run_task(task, device="cuda"):
    """One task: a list of result dicts with their phase."""
    if task == "approx":
        return ([dict(phase="vi", check="cli", **check_cli_approx(device))]
                + [dict(phase="vi", **r) for r in check_approx(device)])
    if task == "pathfinder_init":
        return [dict(phase="vi", check="pathfinder_init", **check_pathfinder_init(device))]
    name, engine = task.split(":")
    return [dict(phase="engines", **run_engine(name, engine, device))]


def main(argv=None):
    ap = argparse.ArgumentParser(description="Drive the port's engines.")
    ap.add_argument("tasks", nargs="*", help=f"of {TASKS} (default: all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nuts", action="store_true",
                    help="then run the port's NUTS once on each engine task's model")
    args = ap.parse_args(argv)
    unknown = set(args.tasks) - set(TASKS)
    if unknown:
        ap.error(f"unknown tasks {sorted(unknown)}")
    ok = True
    tasks = args.tasks or TASKS
    for task in tasks:
        for res in run_task(task, args.device):
            ok = ok and res["ok"]
            print(json.dumps(res), flush=True)
    if args.nuts:
        for name in dict.fromkeys(t.split(":")[0] for t in tasks if ":" in t):
            print(json.dumps(dict(phase="engines", **run_nuts(name, args.device))),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
