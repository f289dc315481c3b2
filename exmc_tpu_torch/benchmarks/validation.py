"""Gold-standard posterior validation on the port
(``exmc_tpu/benchmarks/validation.py``): models whose posterior moments
are known exactly (conjugate families, quadrature, Kalman smoothing,
marginalized Laplace importance sampling) or published (eight schools).

The pass criterion is the JAX battery's: for every gated parameter,
|mean - ref_mean| < 0.5 ref_sd and sd / ref_sd in (0.5, 2.0). The
divergence rate is divergences over chains x draws.

Run golds on the card (one JSON line each, then a summary line):

    python -m exmc_tpu_torch.benchmarks.validation [gold ...] \\
        [--check-compile] [--recipe card|jax]

The card recipe (``card_recipe``) is the default; ``--recipe jax`` runs
the JAX battery's 4 chains x 1000+1000 with each gold's own options.
"""

import argparse
import json
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from exmc_tpu_torch import Builder, dists
from exmc_tpu_torch.compiler import compile_logp
from exmc_tpu_torch.diagnostics import _rhat as rhat
from exmc_tpu_torch.nuts.sampler import _make_sampler
from exmc_tpu_torch.ops import fused_leapfrog_gaussian


@dataclass
class GoldStandard:
    name: str
    ir: object
    ref_means: dict      # param -> exact posterior mean
    ref_sds: dict        # param -> exact posterior sd
    ncp: bool = False
    opts: dict = field(default_factory=dict)     # extra sampler options
    derived: dict = field(default_factory=dict)  # name -> fn(trace) ->
    #   (chains, draws, ...) samples, checked against ref_means/ref_sds
    #   like params (targets analytic only in a function of the free RVs)


def _conjugate_normal(seed=0):
    rng = np.random.default_rng(seed)
    n, true_mu, sigma, prior_sd = 50, 1.5, 1.0, 10.0
    ys = rng.normal(true_mu, sigma, size=n)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": prior_sd})
    ir = Builder.rv(ir, "y", dists.Normal, {"mu": "mu", "sigma": sigma})
    ir = Builder.obs(ir, "y_obs", "y", ys)
    post_var = 1.0 / (1.0 / prior_sd**2 + n / sigma**2)
    post_mean = post_var * ys.sum() / sigma**2
    return GoldStandard(
        "conjugate_normal", ir, {"mu": post_mean}, {"mu": math.sqrt(post_var)}
    )


def _beta_binomial(seed=1):
    rng = np.random.default_rng(seed)
    n, p_true, a0, b0 = 200, 0.3, 2.0, 3.0
    ys = (rng.random(n) < p_true).astype(np.float64)
    k = ys.sum()
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "p", dists.Beta, {"alpha": a0, "beta": b0})
    ir = Builder.rv(ir, "y", dists.Bernoulli, {"p": "p"})
    ir = Builder.obs(ir, "y_obs", "y", ys)
    a, b = a0 + k, b0 + n - k
    mean = a / (a + b)
    sd = math.sqrt(a * b / ((a + b) ** 2 * (a + b + 1)))
    return GoldStandard("beta_binomial", ir, {"p": mean}, {"p": sd})


def _gamma_poisson(seed=2):
    rng = np.random.default_rng(seed)
    n, lam_true, a0, b0 = 80, 3.5, 2.0, 1.0
    ys = rng.poisson(lam_true, size=n).astype(np.float64)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "lam", dists.Gamma, {"alpha": a0, "beta": b0})
    ir = Builder.rv(ir, "y", dists.Poisson, {"mu": "lam"})
    ir = Builder.obs(ir, "y_obs", "y", ys)
    a, b = a0 + ys.sum(), b0 + n
    return GoldStandard(
        "gamma_poisson", ir, {"lam": a / b}, {"lam": math.sqrt(a) / b}
    )


def _normal_known_mean_gamma_precision(seed=3):
    rng = np.random.default_rng(seed)
    n, tau_true, a0, b0 = 100, 0.25, 2.0, 2.0  # tau = precision
    ys = rng.normal(0.0, 1.0 / math.sqrt(tau_true), size=n)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "tau", dists.Gamma, {"alpha": a0, "beta": b0})
    ir = Builder.det(ir, "sigma_det", lambda t: 1.0 / t**0.5, ["tau"])
    ir = Builder.rv(ir, "y", dists.Normal, {"mu": 0.0, "sigma": "sigma_det"})
    ir = Builder.obs(ir, "y_obs", "y", ys)
    a = a0 + n / 2.0
    b = b0 + float((ys**2).sum()) / 2.0
    return GoldStandard(
        "normal_gamma_precision", ir, {"tau": a / b}, {"tau": math.sqrt(a) / b}
    )


def _mvn_conjugate(seed=4):
    rng = np.random.default_rng(seed)
    d, n = 3, 40
    cov = np.array([[1.0, 0.3, 0.1], [0.3, 1.5, 0.2], [0.1, 0.2, 0.8]])
    mu_true = np.array([1.0, -0.5, 0.3])
    ys = rng.multivariate_normal(mu_true, cov, size=n)
    prior_cov = 25.0 * np.eye(d)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.MvNormal, {"mu": np.zeros(d), "cov": prior_cov})
    ir = Builder.rv(ir, "y", dists.MvNormal, {"mu": "mu", "cov": cov})
    y0 = ys[0]  # one observed row keeps the analytic posterior simple
    ir = Builder.obs(ir, "y_obs", "y", y0)
    prec = np.linalg.inv(prior_cov) + np.linalg.inv(cov)
    post_cov = np.linalg.inv(prec)
    post_mean = post_cov @ (np.linalg.inv(cov) @ y0)
    return GoldStandard("mvn_conjugate", ir, {"mu": post_mean},
                        {"mu": np.sqrt(np.diag(post_cov))})


def _eight_schools():
    """Published posterior moments: mu ~ 4.4 (sd ~3.3), tau ~ 3.6
    (half-Cauchy(5) prior, non-centered)."""
    y = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
    sig = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = Builder.rv(ir, "tau", dists.HalfCauchy, {"scale": 5.0})
    for i in range(8):
        ir = Builder.rv(ir, f"theta_{i}", dists.Normal,
                        {"mu": "mu", "sigma": "tau"})
        ir = Builder.rv(ir, f"y_{i}", dists.Normal,
                        {"mu": f"theta_{i}", "sigma": sig[i]})
        ir = Builder.obs(ir, f"y_{i}_obs", f"y_{i}", y[i])
    return GoldStandard(
        "eight_schools_ncp", ir,
        {"mu": 4.4, "tau": 3.6}, {"mu": 3.3, "tau": 3.2}, ncp=True,
    )


CORE_GOLD_STANDARDS = [
    _conjugate_normal,
    _beta_binomial,
    _gamma_poisson,
    _normal_known_mean_gamma_precision,
    _mvn_conjugate,
    _eight_schools,
]

# maker names that differ from their GoldStandard.name, so a ``models``
# filter can skip building the others
ALIASES = {
    "dirichlet_prior_moments": "dirichlet_prior",
    "_conjugate_normal": "conjugate_normal",
    "_beta_binomial": "beta_binomial",
    "_gamma_poisson": "gamma_poisson",
    "_normal_known_mean_gamma_precision": "normal_gamma_precision",
    "_mvn_conjugate": "mvn_conjugate",
    "_eight_schools": "eight_schools_ncp",
}

# The card recipe: many chains are nearly free on the card, a host sync
# is not. Worker processes sharing one card top out at ~1,840 host syncs
# a second in all, whether 4, 6 or 8 run (PERF.md), so the gold phase
# lasts its golds' total syncs over that rate. Iterations a gold sets
# itself scale by warmup / JAX_ITERS and draws / JAX_ITERS.
CARD_RECIPE = {"num_chains": 64, "num_warmup": 120, "num_samples": 120, "seed": 42}
# Golds whose card recipe differs. The masked tree loop runs as long as
# the deepest tree of the batch, so the GRW (depth ~7 throughout) takes
# 16 chains, and 80 + 80 (its own 64 + 64 after the scaling below;
# 150 + 150 until the parallel phase joined chip_smoke.py's pool, then
# 100 + 100). The radon and crossed-effects posteriors are correlated
# Gaussians: a dense metric pooled over the 64 chains whitens them
# (0.64x and 0.53x the diagonal metric's syncs per iteration, and crossed's
# R-hat 1.005 against 1.023). avtest_binomial_glmm's data pin each
# engine's logit to +/-0.05 (~45k trials each): non-centered, that is a
# thin curved ridge mu + sigma_a z_e = c_e where the diagonal metric needs
# depth-9 trees and split R-hat sits at 1.04-1.05; centered, the ridge is
# linear in (mu, a_e), and the dense metric whitens it.
_DENSE_POOLED = {"dense_mass": True, "pooled_adaptation": True}
CARD_OVERRIDES = {
    "grw_kalman_t1000": {"num_chains": 16, "num_warmup": 80, "num_samples": 80},
    "radon_varying_intercept": {"extra_opts": _DENSE_POOLED},
    "crossed_random_effects_lmm": {"extra_opts": _DENSE_POOLED},
    "avtest_binomial_glmm": {"num_chains": 16, "num_warmup": 200, "num_samples": 200,
                             "ncp": False, "extra_opts": {"dense_mass": True}},
}
JAX_RECIPE = {"num_chains": 4, "num_warmup": 1000, "num_samples": 1000, "seed": 42}
JAX_ITERS = 1000
RHAT_MAX = 1.05

# Seconds the longest golds took in the gold phase of chip_smoke.py
# (64 chains x 150+150, GRW 16 x 160+160; four workers sharing an H100
# 80GB HBM3, 700 W); the others took ~5-15 s. Only their order matters:
# a worker pool takes the golds longest first (``card_order``), so the
# long ones never start last.
CARD_COST_S = {
    "grw_kalman_t1000": 113.8,
    "radon_varying_intercept": 68.0,
    "kidiq_regression": 50.8,
    "crossed_random_effects_lmm": 45.9,
    "avtest_binomial_glmm": 38.2,
    "ordered_normal_orderstats": 26.9,
    "eight_schools_ncp": 25.2,
    "mvn_dense_mass": 24.0,
}


def card_recipe(name):
    """``run_gold`` keyword arguments of one gold's card recipe."""
    return dict(CARD_RECIPE, **CARD_OVERRIDES.get(name, {}))


def card_order(names):
    """``names`` longest first by ``CARD_COST_S``, the rest in the given
    order."""
    return sorted(names, key=lambda g: -CARD_COST_S.get(g, 0.0))


def all_gold_standards():
    """The JAX battery's 51 golds in its order: the core six and the 45
    extras (``gold_models.py``), five of them built through the Stan
    frontend."""
    from exmc_tpu_torch.benchmarks.gold_models import EXTRA_GOLD_STANDARDS

    return CORE_GOLD_STANDARDS + EXTRA_GOLD_STANDARDS


def gold_name(make):
    return ALIASES.get(make.__name__, make.__name__)


def build_golds(models=None):
    """{name: GoldStandard} of the golds named in ``models`` (all when
    None), in battery order; only those are built."""
    out = {}
    for make in all_gold_standards():
        if models is None or gold_name(make) in models:
            gs = make()
            out[gs.name] = gs
    return out


def sampler_opts(gs, num_warmup, num_samples):
    """The run's options: the recipe's iterations, with a gold's own
    iterations scaled by the same factor, plus the gold's other opts."""
    opts = dict(gs.opts)
    opts["num_warmup"] = round(opts.get("num_warmup", JAX_ITERS) * num_warmup / JAX_ITERS)
    opts["num_samples"] = round(opts.get("num_samples", JAX_ITERS) * num_samples
                                / JAX_ITERS)
    return opts


def check_against_reference(gs, trace):
    """The JAX battery's criterion per gated parameter, plus how close
    each came: worst |mean - ref| / (0.5 ref_sd) and the sd-ratio
    range. Returns (ok, detail, worst_mean_use, (sd_lo, sd_hi))."""
    ok = True
    detail = {}
    worst, sd_lo, sd_hi = 0.0, math.inf, 0.0
    for param, ref_mean in gs.ref_means.items():
        arr = np.asarray(trace[param], np.float64).reshape(-1, *np.shape(ref_mean))
        got_mean = arr.mean(axis=0)
        got_sd = arr.std(axis=0)
        ref_sd = np.asarray(gs.ref_sds[param])
        ratio = got_sd / ref_sd
        mean_ok = bool(np.all(np.abs(got_mean - ref_mean) < 0.5 * ref_sd))
        sd_ok = bool(np.all((ratio > 0.5) & (ratio < 2.0)))
        ok = ok and mean_ok and sd_ok
        worst = max(worst, float(np.max(np.abs(got_mean - ref_mean) / (0.5 * ref_sd))))
        sd_lo = min(sd_lo, float(np.min(ratio)))
        sd_hi = max(sd_hi, float(np.max(ratio)))
        detail[param] = {
            "mean": np.round(got_mean, 4).tolist(),
            "ref_mean": np.round(np.asarray(ref_mean, float), 4).tolist(),
            "sd": np.round(got_sd, 4).tolist(),
            "ref_sd": np.round(ref_sd, 4).tolist(),
            "pass": mean_ok and sd_ok,
        }
    return ok, detail, worst, (sd_lo, sd_hi)


def max_split_rhat(gs, trace):
    worst = 0.0
    for param in gs.ref_means:
        arr = np.asarray(trace[param])
        flat = arr.reshape(arr.shape[0], arr.shape[1], -1)
        for i in range(flat.shape[-1]):
            worst = max(worst, float(rhat(flat[:, :, i])))
    return worst


def run_gold(gs, num_chains, num_warmup, num_samples, seed, device=None,
             extra_opts=None, ncp=None):
    """Sample one gold and hold it to the battery's criterion
    (``extra_opts`` are sampler options on top of the gold's; ``ncp``
    overrides the gold's). Returns the JAX battery's result fields plus
    the run's wall, host syncs, peak device memory and the R-hat/finite
    gates."""
    opts = dict(sampler_opts(gs, num_warmup, num_samples), **(extra_opts or {}))
    ncp = gs.ncp if ncp is None else ncp
    sampler = _make_sampler(gs.ir, ncp=ncp, device=device, **opts)
    dev = sampler.model.device
    base = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    trace, stats = sampler.run(num_chains=num_chains, seed=seed)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trace = dict(trace)
    for dname, fn in gs.derived.items():
        trace[dname] = np.asarray(fn(trace))
    ok, detail, worst, sd_range = check_against_reference(gs, trace)
    max_rhat = max_split_rhat(gs, trace)
    finite = bool(all(np.isfinite(np.asarray(trace[p])).all() for p in gs.ref_means))
    n_total = int(np.asarray(stats["diverging"]).size)
    iters = opts["num_warmup"] + opts["num_samples"]
    gates = []
    if not ok:
        gates.append("moments")
    if not finite:
        gates.append("non-finite draws")
    if not max_rhat < RHAT_MAX:
        gates.append(f"max R-hat {max_rhat:.4f} >= {RHAT_MAX}")
    return {
        "model": gs.name,
        "pass": ok,
        "gates_pass": not gates,
        "gate_failures": gates,
        "d": sampler.model.size,
        "chains": num_chains,
        "iterations": [opts["num_warmup"], opts["num_samples"]],
        "ncp": ncp,
        "opts": {k: v for k, v in opts.items()
                 if k not in ("num_warmup", "num_samples")},
        "wall_s": wall,
        "divergences": int(stats["divergences"].sum()),
        "divergence_rate": float(stats["divergences"].sum()) / max(n_total, 1),
        "max_rhat": max_rhat,
        "worst_mean_use": worst,
        "sd_ratio_range": list(sd_range),
        "host_syncs": sampler.last_run["host_syncs"],
        "host_syncs_per_iter": sampler.last_run["host_syncs"] / iters,
        "mean_depth": float(stats["depth"].mean()),
        # device memory the run allocated above what the process held
        "peak_mb": ((torch.cuda.max_memory_allocated(dev) - base) / 2**20
                    if dev.type == "cuda" else None),
        "params": detail,
    }


def compile_check(gs, device="cuda", n_points=8, seed=0, tol=1e-4):
    """The gold compiled on ``device`` against the same gold compiled on
    the CPU: value and gradient at ``n_points`` seeded flat points,
    |dlogp| <= tol max(1, |logp|) and |dgrad| <= tol max(1, |grad|_inf)
    per point. Returns (ok, worst relative logp error, worst relative
    grad error)."""
    dev = compile_logp(gs.ir, ncp=gs.ncp, device=device)
    cpu = compile_logp(gs.ir, ncp=gs.ncp, device="cpu")
    flat = np.random.default_rng(seed).uniform(-2, 2, size=(n_points, cpu.size))
    x = torch.as_tensor(flat, dtype=torch.float32)
    ld, gd = dev.value_and_grad(x.to(dev.device))
    lc, gc = cpu.value_and_grad(x)
    ld, gd = ld.cpu(), gd.cpu()
    e_lp = ((ld - lc).abs() / torch.clamp_min(lc.abs(), 1.0))
    e_g = ((gd - gc).abs().amax(-1) / torch.clamp_min(gc.abs().amax(-1), 1.0))
    ok = bool((e_lp <= tol).all() & (e_g <= tol).all()
              & torch.isfinite(lc).all() & torch.isfinite(gc).all())
    return ok, float(e_lp.max()), float(e_g.max())


def run_named_gold(name, recipe="card", device="cuda", check_compile=True):
    """Build one gold, hold its compiled model against the CPU's
    (``check_compile``) and sample it under ``recipe`` ("card":
    ``card_recipe``; "jax": the JAX battery's). The result carries the
    fused-leapfrog kernel's launches during the gold's run; a worker
    process of a pool runs this for one gold at a time."""
    gs = build_golds([name])[name]
    res = {}
    if check_compile:
        ok, e_lp, e_g = compile_check(gs, device=device)
        res["compile_check"] = {"ok": ok, "logp_rel_err": e_lp, "grad_rel_err": e_g}
    fused_leapfrog_gaussian.launches = 0
    res.update(run_gold(gs, device=device,
                        **(card_recipe(name) if recipe == "card" else JAX_RECIPE)))
    res["fused_leapfrog_gaussian_launches"] = fused_leapfrog_gaussian.launches
    return res


def validate(num_warmup=1000, num_samples=1000, num_chains=4, seed=42,
             verbose=True, models=None, device=None, full=True):
    """Run the battery (every gold, or those named in ``models``) on the
    port's sampler; the defaults are the JAX battery's recipe. ``full``:
    the whole battery, else the core six. Returns (n_pass, results)."""
    if not full:
        core = {gold_name(m) for m in CORE_GOLD_STANDARDS}
        models = core if models is None else [m for m in models if m in core]
    results = []
    for gs in build_golds(models).values():
        res = run_gold(gs, num_chains, num_warmup, num_samples, seed, device)
        results.append(res)
        if verbose:
            print(f"{gs.name}: {'PASS' if res['pass'] else 'FAIL'} "
                  f"(div={res['divergences']}, max_rhat={res['max_rhat']:.3f})")
    return sum(r["pass"] for r in results), results


def main(argv=None):
    ap = argparse.ArgumentParser(description="Run gold standards on the port.")
    ap.add_argument("golds", nargs="*", help="gold names (default: all 51)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--recipe", choices=("card", "jax"), default="card",
                    help="card: card_recipe(gold); jax: the JAX battery's "
                         "4 chains x 1000+1000 with the gold's own options")
    ap.add_argument("--check-compile", action="store_true",
                    help="hold the compiled gold against the CPU first")
    args = ap.parse_args(argv)
    names = [gold_name(m) for m in all_gold_standards()
             if not args.golds or gold_name(m) in args.golds]
    t0 = time.perf_counter()
    n_pass = launches = 0
    for name in names:
        res = run_named_gold(name, args.recipe, args.device, args.check_compile)
        n_pass += res["gates_pass"] and res.get("compile_check", {"ok": True})["ok"]
        launches += res["fused_leapfrog_gaussian_launches"]
        print(json.dumps(res), flush=True)
    print(json.dumps({"n_pass": n_pass, "n": len(names),
                      "seconds": time.perf_counter() - t0,
                      "fused_leapfrog_gaussian_launches": launches}), flush=True)


if __name__ == "__main__":
    main()
