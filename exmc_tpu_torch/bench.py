"""The headline benchmark of ``bench.py`` on the port: eight-schools NUTS,
1024 chains, superchain init K=32, 200 warmup + 500 draws, pooled
adaptation, ensemble rescue, target_accept 0.8, max_depth 10.

Run on the card with ``python -m exmc_tpu_torch.bench``; prints one JSON
line with the fields of ``bench.py`` plus the port's own counts.
``--profile --warmup 20 --draws 10`` instead profiles a short run and
prints the device's busy share and its top kernels. Wall time is one
run after a short warm-up run (the port compiles nothing;
the warm-up run pays for CUDA context, allocator and library start-up).
"""

import argparse
import json
import time

import numpy as np
import torch

from exmc_tpu_torch import Builder, dists
from exmc_tpu_torch.diagnostics import _ess as ess, _nested_rhat as nested_rhat
from exmc_tpu_torch.nuts.sampler import _make_sampler

Y = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
SIGMA = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]
BASELINE_PYMC_ESS_S = 5.0  # BASELINE.md eight_schools PyMC, 1 chain


def eight_schools_ir():
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = Builder.rv(ir, "tau", dists.HalfCauchy, {"scale": 5.0})
    for i in range(8):
        ir = Builder.rv(ir, f"theta_{i}", dists.Normal,
                        {"mu": "mu", "sigma": "tau"})
        ir = Builder.rv(ir, f"y_{i}", dists.Normal,
                        {"mu": f"theta_{i}", "sigma": SIGMA[i]})
        ir = Builder.obs(ir, f"y_{i}_obs", f"y_{i}", Y[i])
    return ir


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(device="cuda", num_chains=1024, num_warmup=200, num_samples=500,
        num_superchains=32, warm_up=(20, 10), seed=1):
    """Warm-up run (``warm_up`` = (warmup, draws) iterations, seed 0),
    then the timed run. Returns the result dict."""
    sc_init = ("superchain", num_superchains)
    t0 = time.perf_counter()
    first = _make_sampler(eight_schools_ir(), device=device,
                          num_warmup=warm_up[0], num_samples=warm_up[1],
                          pooled_adaptation=True)
    first.run(num_chains=num_chains, seed=0, init=sc_init)
    _sync(device)
    first_s = time.perf_counter() - t0

    sampler = _make_sampler(eight_schools_ir(), device=device,
                            num_warmup=num_warmup, num_samples=num_samples,
                            pooled_adaptation=True)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trace, stats = sampler.run(num_chains=num_chains, seed=seed, init=sc_init)
    _sync(device)
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else None)

    mu = trace["mu"]
    ess_mu = float(ess(mu))
    return {
        "metric": (f"eight_schools ESS/s (mu), {num_chains} batched NUTS "
                   "chains, exmc_tpu_torch"),
        "value": ess_mu / wall,
        "unit": "ESS/s",
        "vs_baseline": ess_mu / wall / BASELINE_PYMC_ESS_S,
        "detail": {
            "device": (torch.cuda.get_device_name(0)
                       if torch.device(device).type == "cuda" else "cpu"),
            "wall_s": wall,
            "compile_and_first_run_s": first_s,
            "first_run_iterations": list(warm_up),
            "draws_per_s": num_chains * num_samples / wall,
            "ess_mu": ess_mu,
            "mu_mean": float(np.mean(mu)),
            "tau_mean": float(np.mean(trace["tau"])),
            "nested_rhat_mu_k32": float(nested_rhat(mu, num_superchains)),
            "nested_rhat_tau_k32": float(nested_rhat(trace["tau"],
                                                     num_superchains)),
            "init": (f"superchain K={num_superchains} x "
                     f"M={num_chains // num_superchains}"),
            "divergence_rate": float(stats["divergences"].sum())
            / (num_chains * num_samples),
            "mean_tree_depth": float(stats["depth"].mean()),
            "leapfrog_steps_sampling": int(stats["n_steps"].sum()),
            "host_syncs": sampler.last_run["host_syncs"],
            "iterations": [num_warmup, num_samples],
            "peak_memory_bytes": peak,
            "baseline": "PyMC 1-chain 5 ESS/s (STANDARD_BENCHMARKS.md:139)",
        },
    }


def profile(num_chains=1024, num_warmup=20, num_samples=10):
    """A short run of the pipeline on the card under ``torch.profiler``,
    after one unprofiled run of the same length. Returns the wall time,
    the summed device time of the kernels, their share of the wall (the
    device's busy share; the profiler's own host cost lowers it), the
    kernel launches, and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    sampler = _make_sampler(eight_schools_ir(), device="cuda",
                            num_warmup=num_warmup, num_samples=num_samples,
                            pooled_adaptation=True)
    sampler.run(num_chains=num_chains, seed=0, init=("superchain", 32))
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sampler.run(num_chains=num_chains, seed=1, init=("superchain", 32))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "device": torch.cuda.get_device_name(0),
        "iterations": [num_warmup, num_samples],
        "wall_s_profiled": wall,
        "device_kernel_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall,
        "kernel_launches": len(kernels),
        "host_syncs": sampler.last_run["host_syncs"],
        "top_kernels_s": [[name, us / 1e6] for name, us in top],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chains", type=int, default=1024)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--draws", type=int, default=500)
    ap.add_argument("--profile", action="store_true",
                    help="profile a short run on the card instead "
                         "(--warmup/--draws set its length)")
    args = ap.parse_args(argv)
    if args.profile:
        out = profile(num_chains=args.chains, num_warmup=args.warmup,
                      num_samples=args.draws)
    else:
        out = run(device=args.device, num_chains=args.chains,
                  num_warmup=args.warmup, num_samples=args.draws)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
