"""The seven-model suite on the port (``exmc_tpu/benchmarks/suite.py``).

The model builders are copies of the JAX package's, with the same seeds
and data generators, so both packages sample the same posteriors.
``SUITE_RECIPE`` is the JAX package's recipe
(``scripts/run_suite_bench.py:18-80``): chain counts, which models run
centered, and the interweave/gibbs_scales options.

Run one model on the card:

    python -m exmc_tpu_torch.benchmarks.suite sv --warmup 150 --draws 150

It prints one JSON line: the JAX package's result fields, plus host
syncs per iteration, mean tree depth, the interweave acceptance, peak
device memory, the posterior gates against ``REFERENCES``, the
fused-leapfrog kernel's launches during the run, and on the card the
number of interweave groups whose step and conditional metric ran once
under CUDA's sync check.
"""

import argparse
import json
import time

import numpy as np
import torch

from exmc_tpu_torch import Builder, dists
from exmc_tpu_torch.diagnostics import _ess as ess, _rhat as rhat
from exmc_tpu_torch.nuts.interweave import eligible_groups
from exmc_tpu_torch.nuts.sampler import _make_sampler
from exmc_tpu_torch.ops import fused_leapfrog_gaussian


def simple_model():
    """simple (d=2): location+scale on 10 obs."""
    ys = np.array([2.1, 1.8, 2.5, 2.0, 1.9, 2.3, 2.2, 1.7, 2.4, 2.6])
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = Builder.rv(ir, "sigma", dists.HalfNormal, {"sigma": 2.0})
    ir = Builder.rv(ir, "y", dists.Normal, {"mu": "mu", "sigma": "sigma"})
    ir = Builder.obs(ir, "y_obs", "y", ys)
    return ir


def _grouped_hierarchical(n_groups, seed=7):
    """mu, tau, theta_g (g groups), sigma -> d = 3 + n_groups."""
    rng = np.random.default_rng(seed)
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = Builder.rv(ir, "tau", dists.HalfNormal, {"sigma": 2.0})
    ir = Builder.rv(ir, "sigma", dists.HalfNormal, {"sigma": 1.0})
    true_theta = rng.normal(1.0, 1.5, size=n_groups)
    for g in range(n_groups):
        ys = rng.normal(true_theta[g], 0.8, size=20)
        ir = Builder.rv(ir, f"theta_{g}", dists.Normal,
                        {"mu": "mu", "sigma": "tau"})
        ir = Builder.rv(ir, f"y_{g}", dists.Normal,
                        {"mu": f"theta_{g}", "sigma": "sigma"})
        ir = Builder.obs(ir, f"y_{g}_obs", f"y_{g}", ys)
    return ir


def medium_model():
    return _grouped_hierarchical(2)


def stress_model():
    return _grouped_hierarchical(5)


def eight_schools_model():
    """Rubin 1981 with a HalfNormal(5) tau, centered unless compiled with
    ncp=True."""
    y = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
    sig = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = Builder.rv(ir, "tau", dists.HalfNormal, {"sigma": 5.0})
    for i in range(8):
        ir = Builder.rv(ir, f"theta_{i}", dists.Normal,
                        {"mu": "mu", "sigma": "tau"})
        ir = Builder.rv(ir, f"y_{i}", dists.Normal,
                        {"mu": f"theta_{i}", "sigma": sig[i]})
        ir = Builder.obs(ir, f"y_{i}_obs", f"y_{i}", y[i])
    return ir


def funnel_model():
    """Neal's funnel (d=10): y ~ N(0, 3); x_i ~ N(0, exp(y/2)), i=1..9;
    no observations."""
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "y", dists.Normal, {"mu": 0.0, "sigma": 3.0})
    ir = Builder.det(ir, "y_half", "mul", ["y", 0.5])
    ir = Builder.det(ir, "scale", "exp", ["y_half"])
    ir = Builder.rv(ir, "x", dists.Normal, {"mu": 0.0, "sigma": "scale"},
                    shape=(9,))
    return ir


def logistic_model(n=500, p=20, seed=11):
    """Logistic regression (d=21): alpha, beta_j ~ N(0, 10);
    y ~ Bernoulli(logits = alpha + X beta), n = 500."""
    rng = np.random.default_rng(seed)
    x_mat = rng.normal(size=(n, p)).astype(np.float32)
    true_beta = rng.normal(0, 0.5, size=p)
    logits = 0.5 + x_mat @ true_beta
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)

    ir = Builder.new_ir()
    ir = Builder.rv(ir, "alpha", dists.Normal, {"mu": 0.0, "sigma": 10.0})
    ir = Builder.rv(ir, "beta", dists.Normal, {"mu": 0.0, "sigma": 10.0},
                    shape=(p,))
    ir = Builder.det(ir, "xb", "matmul", [x_mat, "beta"])
    ir = Builder.det(ir, "eta", "add", ["xb", "alpha"])
    ir = Builder.rv(ir, "y", dists.Bernoulli, {"logits": "eta"}, shape=(n,))
    ir = Builder.obs(ir, "y_obs", "y", y)
    return ir


def sv_model(t=100, seed=13):
    """Stochastic volatility (d=t+2): sigma ~ Exp(50); nu ~ Exp(0.1);
    s ~ GaussianRandomWalk(sigma) over t steps; r_i ~ StudentT(nu, 0,
    exp(s_i)) observed. The innovation scale goes as sqrt(100/t)."""
    rng = np.random.default_rng(seed)
    true_sigma = 0.15 * float(np.sqrt(100.0 / t))
    s_true = np.cumsum(rng.normal(0, true_sigma, size=t))
    r = (rng.standard_t(10, size=t) * np.exp(s_true)).astype(np.float32)

    ir = Builder.new_ir()
    ir = Builder.rv(ir, "sigma", dists.Exponential, {"lambda": 50.0})
    ir = Builder.rv(ir, "nu", dists.Exponential, {"lambda": 0.1})
    ir = Builder.rv(ir, "s", dists.GaussianRandomWalk, {"sigma": "sigma"},
                    shape=(t,))
    ir = Builder.det(ir, "vol", "exp", ["s"])
    ir = Builder.rv(ir, "r", dists.StudentT,
                    {"df": "nu", "loc": 0.0, "scale": "vol"}, shape=(t,))
    ir = Builder.obs(ir, "r_obs", "r", r)
    return ir


MODELS = {
    "simple": simple_model,
    "medium": medium_model,
    "stress": stress_model,
    "eight_schools": eight_schools_model,
    "funnel": funnel_model,
    "logistic": logistic_model,
    "sv": sv_model,
}

# ESS/s baselines of the original eXMC and of PyMC (1000+1000, 5-seed
# medians, 88-thread Xeon; BASELINE.md): (eXMC, PyMC)
REFERENCE_ESS_PER_S = {
    "simple": (454.0, 560.0),
    "medium": (270.0, 163.0),
    "stress": (217.0, 174.0),
    "eight_schools": (12.0, 5.0),
    "funnel": (2.0, 6.0),
    "logistic": (69.0, 336.0),
    "sv": (1.2, 1.0),
}

_GIBBS = {"target_accept": 0.8, "interweave": True, "gibbs_scales": True}

# The JAX package's suite recipe (scripts/run_suite_bench.py:18-80):
# chains, auto-NCP on/off, and sampler options per model.
SUITE_RECIPE = {
    "simple": {"chains": 256, "ncp": True, "opts": {}},
    "medium": {"chains": 256, "ncp": False, "opts": dict(_GIBBS)},
    "stress": {"chains": 256, "ncp": False, "opts": dict(_GIBBS)},
    "eight_schools": {"chains": 256, "ncp": False, "opts": dict(_GIBBS)},
    "funnel": {"chains": 128, "ncp": True, "opts": {}},
    "logistic": {"chains": 128, "ncp": True, "opts": {}},
    "sv": {"chains": 64, "ncp": True, "opts": {"interweave": True}},
}

# The posterior quantities each model's gate compares: scalars by name,
# and for a vector its first element ("x[0]") and its element mean
# ("x[mean]").
GATE_PARAMS = {
    "simple": ("mu", "sigma"),
    "medium": ("mu", "tau", "sigma"),
    "stress": ("mu", "tau", "sigma"),
    "eight_schools": ("mu", "tau"),
    "funnel": ("y", "x[0]", "x[mean]"),
    "logistic": ("alpha", "beta[0]", "beta[mean]"),
    "sv": ("sigma", "nu", "s[0]", "s[mean]"),
}

# JAX-package posterior (mean, sd, MCSE = sd / sqrt(ESS)) of each gate
# quantity under SUITE_RECIPE on the CPU, one run per model at
# REFERENCE_SETTINGS (chains, warmup + draws, seed), printed by
#     JAX_PLATFORMS=cpu python tests/test_torch_suite_refs.py
# and rounded to 6 significant digits.
REFERENCE_SETTINGS = {"chains": 32, "warmup": 1000, "draws": 2000, "seed": 1}
REFERENCES = {
    "simple": {
        "mu": (2.14812, 0.115793, 0.000652202),
        "sigma": (0.353267, 0.10197, 0.000654533),
    },
    "medium": {
        "mu": (0.875336, 0.90711, 0.00358273),
        "tau": (1.03918, 0.877508, 0.00729746),
        "sigma": (0.681006, 0.0808456, 0.000368608),
    },
    "stress": {
        "mu": (0.473642, 0.402635, 0.0013413),
        "tau": (0.794299, 0.40874, 0.00287547),
        "sigma": (0.740629, 0.0543899, 0.000235323),
    },
    "eight_schools": {
        "mu": (4.42905, 3.29243, 0.0294396),
        "tau": (3.2917, 2.49018, 0.0147069),
    },
    "funnel": {
        "y": (0.0024501, 3.00435, 0.00858156),
        "x[0]": (0.0150081, 8.78723, 0.038812),
        "x[mean]": (-0.00314315, 2.96276, 0.0130499),
    },
    "logistic": {
        "alpha": (0.477224, 0.130219, 0.000412931),
        "beta[0]": (0.784317, 0.131407, 0.000463627),
        "beta[mean]": (-0.30182, 0.0361847, 0.000153297),
    },
    "sv": {
        "sigma": (0.133283, 0.0368518, 0.000210458),
        "nu": (6.32437, 5.93607, 0.0296846),
        "s[0]": (0.0612637, 0.127616, 0.000382135),
        "s[mean]": (1.32041, 0.142743, 0.000603188),
    },
}

# Gates of one run of a model (chip_smoke.py's suite phase).
RHAT_MAX = 1.05
DIVERGENCE_RATE_MAX = 5e-3
MEAN_SD_SLACK = 0.1
MEAN_MCSE_SIGMAS = 4.0


def build_model(name):
    return MODELS[name]()


def gate_values(name, trace):
    """{quantity: (chains, draws) numpy} of the model's GATE_PARAMS."""
    out = {}
    for q in GATE_PARAMS[name]:
        base, _, idx = q.partition("[")
        arr = np.asarray(trace[base], np.float64)
        if idx == "0]":
            arr = arr[..., 0]
        elif idx == "mean]":
            arr = arr.mean(axis=-1)
        out[q] = arr
    return out


def posterior_summary(name, trace):
    """{quantity: (mean, sd, MCSE)} with MCSE = sd / sqrt(ESS)."""
    out = {}
    for q, arr in gate_values(name, trace).items():
        sd = float(arr.std())
        out[q] = (float(arr.mean()), sd,
                  sd / float(np.sqrt(float(ess(arr)))))
    return out


def gate_failures(name, result):
    """The gates a ``run_model`` result breaks, as messages (empty when
    it passes): finite draws, max split R-hat, divergence rate, and each
    gate quantity's mean within 0.1 sd + 4 sqrt(MCSE^2 + MCSE_ref^2) of
    the JAX package's."""
    fails = []
    if not result["all_finite"]:
        fails.append("non-finite draws")
    if not result["max_rhat"] < RHAT_MAX:
        fails.append(f"max R-hat {result['max_rhat']} >= {RHAT_MAX}")
    if not result["divergence_rate"] < DIVERGENCE_RATE_MAX:
        fails.append(f"divergence rate {result['divergence_rate']} >= "
                     f"{DIVERGENCE_RATE_MAX}")
    for q, (m_ref, sd_ref, mcse_ref) in REFERENCES[name].items():
        m, _, mcse = result["posterior"][q]
        tol = (MEAN_SD_SLACK * sd_ref
               + MEAN_MCSE_SIGMAS * float(np.hypot(mcse, mcse_ref)))
        if not abs(m - m_ref) <= tol:
            fails.append(f"{q} mean {m} vs reference {m_ref} (tolerance {tol})")
    return fails


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _seed_metrics(trace, stats, wall, num_chains, num_samples):
    """The per-seed metrics of one timed run."""
    ess_vals, rhat_vals = {}, {}
    for key0, arr in trace.items():
        flat = arr.reshape(arr.shape[0], arr.shape[1], -1)
        for i in range(flat.shape[-1]):
            key = key0 if flat.shape[-1] == 1 else f"{key0}[{i}]"
            ess_vals[key] = float(ess(flat[:, :, i]))
            rhat_vals[key] = float(rhat(flat[:, :, i]))
    min_ess = min(ess_vals.values())
    return {
        "wall_s": wall,
        "min_ess": min_ess,
        "min_ess_per_s": min_ess / wall,
        "median_ess": float(np.median(list(ess_vals.values()))),
        "max_rhat": max(rhat_vals.values()),
        "divergence_rate": float(stats["divergences"].sum())
        / (num_chains * num_samples),
        "mean_depth": float(stats["depth"].mean()),
    }


def run_model(name, num_chains=None, num_warmup=1000, num_samples=1000,
              seed=0, device=None, warm_up=(10, 10), ncp=None, chunked=None,
              seeds=1, **opts):
    """Run one suite model under SUITE_RECIPE (``num_chains`` overrides
    its chain count, ``ncp`` its auto-NCP flag, ``opts`` its sampler
    options). A short warm-up run of ``warm_up`` = (warmup, draws)
    iterations with ``seed`` comes first; the ``seeds`` timed runs use
    ``seed + 1``, ``seed + 2``, ... and each ends in
    ``torch.cuda.synchronize()``. The metrics are the per-seed medians,
    as in the JAX package (``per_seed`` holds each run's); the posterior
    and the host syncs are the first timed run's. ``chunked`` runs each
    timed run through ``run_chunked`` in chunks of that many
    iterations. Returns the JAX package's result fields plus the port's
    own counts."""
    recipe = SUITE_RECIPE[name]
    num_chains = recipe["chains"] if num_chains is None else num_chains
    ncp = recipe["ncp"] if ncp is None else ncp
    opts = dict(recipe["opts"], **opts)
    sampler = _make_sampler(build_model(name), ncp=ncp,
                            device=device, num_warmup=num_warmup,
                            num_samples=num_samples, **opts)
    dev = sampler.model.device
    first = _make_sampler(sampler.model, num_warmup=warm_up[0],
                          num_samples=warm_up[1], **opts)
    t0 = time.perf_counter()
    first.run(num_chains=num_chains, seed=seed)
    _sync(dev)
    warm_up_s = time.perf_counter() - t0

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    per_seed = []
    for k in range(seeds):
        t0 = time.perf_counter()
        if chunked:
            tr, st = sampler.run_chunked(num_chains=num_chains, seed=seed + 1 + k,
                                         chunk_iters=chunked)
        else:
            tr, st = sampler.run(num_chains=num_chains, seed=seed + 1 + k)
        _sync(dev)
        wall = time.perf_counter() - t0
        per_seed.append(_seed_metrics(tr, st, wall, num_chains, num_samples))
        if k == 0:
            trace, stats, host_syncs = tr, st, sampler.last_run["host_syncs"]
    med = {k: float(np.median([r[k] for r in per_seed])) for k in per_seed[0]}
    iters = num_warmup + num_samples
    ref_exmc, ref_pymc = REFERENCE_ESS_PER_S[name]
    return {
        "model": name,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "num_chains": num_chains,
        "d": sampler.model.size,
        "iterations": [num_warmup, num_samples],
        "seed": seed + 1,
        "n_seeds": seeds,
        "warm_up_s": warm_up_s,
        **med,
        "vs_exmc": med["min_ess_per_s"] / ref_exmc,
        "vs_pymc": med["min_ess_per_s"] / ref_pymc,
        "host_syncs": host_syncs,
        "host_syncs_per_iter": host_syncs / iters,
        "iw_accept_mean": (float(stats["iw_accept"].mean())
                           if "iw_accept" in stats else None),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "all_finite": bool(all(np.isfinite(v).all() for v in trace.values())),
        "posterior": posterior_summary(name, trace),
        "per_seed": per_seed,
    }


def run_suite(models=None, **kwargs):
    """``run_model`` of every suite model (or those named in ``models``)
    with the same keyword arguments: {name: result}."""
    return {name: run_model(name, **kwargs) for name in models or MODELS}


def check_step_syncs(name):
    """Run the model's interweave step and conditional metric once on
    random points at the recipe's chain count on the card, under CUDA's
    sync check, which raises on a device -> host sync. Returns the
    number of interweave groups (0 when the recipe has no interweave)."""
    recipe = SUITE_RECIPE[name]
    if not recipe["opts"].get("interweave"):
        return 0
    smp = _make_sampler(build_model(name), ncp=recipe["ncp"], device="cuda",
                        **recipe["opts"])
    c, d = recipe["chains"], smp.model.size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q = torch.rand(c, d, generator=gen, device="cuda") * 2.0 - 1.0
    inv = torch.ones(c, d, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        q, _ = smp._iw_fn(q, gen)
        if smp._cond_metric_fn is not None:
            inv = smp._cond_metric_fn(q, inv)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return len(eligible_groups(smp.model))


def run_checked(name, num_warmup, num_samples, device=None, seed=0):
    """``run_model`` under the recipe, with the gate failures and the
    references added; on the card also the interweave groups that passed
    ``check_step_syncs``."""
    res = run_model(name, num_warmup=num_warmup, num_samples=num_samples,
                    seed=seed, device=device)
    res["gate_failures"] = gate_failures(name, res)
    res["reference"] = REFERENCES[name]
    res["reference_settings"] = REFERENCE_SETTINGS
    if res["device"] != "cpu":
        res["gibbs_groups_sync_checked"] = check_step_syncs(name)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Run one suite model under the JAX package's recipe.")
    ap.add_argument("model", choices=sorted(MODELS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--warmup", type=int, default=1000)
    ap.add_argument("--draws", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    fused_leapfrog_gaussian.launches = 0
    res = run_checked(args.model, args.warmup, args.draws,
                      device=args.device, seed=args.seed)
    res["kernel_launches"] = {
        "fused_leapfrog_gaussian": fused_leapfrog_gaussian.launches}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
