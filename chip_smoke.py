"""Smoke run of exmc_tpu_torch on one CUDA card.

    python3 chip_smoke.py            # the full run: one card, no arguments

Phases, each printing one JSON line:
  1. device  — the card's name, the device count, nvidia-smi's name and
               power limit;
  2. build   — nvcc build of every source in exmc_tpu_torch/csrc, with
               its seconds and the -Xptxas -v report;
  3. ops     — the public op ``fused_leapfrog_gaussian`` driven at four
               shapes (launch counts read around that run), then each
               kernel held against its plain PyTorch version on the same
               inputs and timed with CUDA events beside its bound;
  4. main    — the bench pipeline (eight schools, 1024 chains, superchain
               K=32, 200+500 iterations, pooled adaptation, ensemble
               rescue, max_depth 10) with its posterior checked against
               the statistical target, and the compiled model checked
               against the same model on the CPU;
  5. suite   — the seven-model suite under the JAX package's recipe
               (chain counts, centered models, interweave and
               gibbs_scales) at full width, one seed, SUITE_ITERS
               iterations; one line per model, each held to its gates
               (finite draws, split R-hat, divergence rate, posterior
               means against the JAX package's), with the interweave step
               and conditional metric run once under CUDA's sync check;
  6. golds   — the 46 non-Stan gold standards of the JAX package's
               validation battery (exmc_tpu_torch/benchmarks), each
               compiled on the card and held against the CPU at 8 points,
               sampled under the card recipe at full width and held to the
               battery's criterion, max split R-hat and finite draws; run
               by a pool of GOLD_WORKERS processes, one JSON line per gold
               and a summary line; a gold that fails only under the card
               recipe is run again at the JAX battery's recipe;
  7. kernels — one JSON object with every kernel's numbers.
The last line is {"ok": true, "device": {...}}. Any failed check exits
non-zero before it. Without a CUDA card the script exits 2 at once.
"""

import argparse
import json
import multiprocessing
import subprocess
import sys
import time

import numpy as np
import torch

from exmc_tpu_torch import _build, compile_logp
from exmc_tpu_torch import bench
from exmc_tpu_torch.benchmarks import suite, validation
from exmc_tpu_torch.ops.fused_leapfrog import (
    fused_leapfrog_gaussian,
    reference_leapfrog_gaussian,
)

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and
# f32 outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

OPS_SHAPES = [(8, 4, 16), (16, 128, 64), (1024, 256, 32), (8192, 256, 2048)]
OPS_EPS = 0.05
TOL_QP = 1e-4          # |kernel - plain| on q and p (same f32 steps, no FMA)
TOL_LOGP_ABS = 1e-3    # logp sums d terms in another order than torch.sum
TOL_LOGP_REL = 1e-5

# Suite phase: (warmup, draws) of every model, one seed. The JAX
# package's suite runs 1000+1000 x 5 seeds; this is the shortest run the
# gates are stated for, and it keeps the script within half its time
# limit on one card (PERF.md, "Suite on the card").
SUITE_ITERS = (150, 150)

# Gold phase: worker processes sharing the card (one host sync per tree
# leaf; together they reach ~1,840 syncs/s whether 4, 6 or 8 run,
# PERF.md), each taking the next gold, longest first.
GOLD_WORKERS = 4


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, reps, warmup=2):
    """Mean ms of ``fn()`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def leapfrog_inputs(c, d, seed):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(c, d)), rng.normal(size=(c, d)),
            rng.normal(size=d), rng.uniform(0.5, 2.0, size=d),
            rng.uniform(0.5, 1.5, size=d))
    return [torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in arrs]


def leapfrog_bound(c, d, k):
    nbytes = 4 * (4 * c * d + 3 * d + c)
    ops = 10 * k * c * d + 4 * c * d
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_ops():
    """Drive the op's path, then compare and time each shape."""
    fused_leapfrog_gaussian.launches = 0
    for i, (c, d, k) in enumerate(OPS_SHAPES):
        q, p, mu, prec, inv = leapfrog_inputs(c, d, i)
        qf, pf, lf = fused_leapfrog_gaussian(q, p, mu, prec, inv, OPS_EPS, k)
        torch.cuda.synchronize()
        if qf.shape != (c, d) or lf.shape != (c,) or not bool(
                torch.isfinite(qf).all() & torch.isfinite(pf).all()
                & torch.isfinite(lf).all()):
            fail(f"fused_leapfrog_gaussian at {(c, d, k)}: bad output")
    path_launches = fused_leapfrog_gaussian.launches

    rows = []
    for i, (c, d, k) in enumerate(OPS_SHAPES):
        q, p, mu, prec, inv = leapfrog_inputs(c, d, i)
        qf, pf, lf = fused_leapfrog_gaussian(q, p, mu, prec, inv, OPS_EPS, k)
        qr, pr, lr = reference_leapfrog_gaussian(q, p, mu, prec, inv, OPS_EPS, k)
        torch.cuda.synchronize()
        err_qp = max(float((qf - qr).abs().max()), float((pf - pr).abs().max()))
        err_logp = float((lf - lr).abs().max())
        logp_ok = bool(((lf - lr).abs()
                        <= TOL_LOGP_ABS + TOL_LOGP_REL * lr.abs()).all())
        kernel_ms = time_cuda(
            lambda: fused_leapfrog_gaussian(q, p, mu, prec, inv, OPS_EPS, k),
            reps=20 if k * c * d > 1e9 else 200)
        plain_ms = time_cuda(
            lambda: reference_leapfrog_gaussian(q, p, mu, prec, inv, OPS_EPS, k),
            reps=3 if k * c * d > 1e9 else 20, warmup=1)
        bound_ms, bound_by = leapfrog_bound(c, d, k)
        row = {"shape_c_d_k": [c, d, k], "max_abs_err_qp": err_qp,
               "max_abs_err_logp": err_logp, "ms": kernel_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "share_of_bound": bound_ms / kernel_ms,
               "library_ms": None}
        emit({"phase": "ops", "kernel": "fused_leapfrog_gaussian", **row})
        if err_qp > TOL_QP or not logp_ok:
            fail(f"fused_leapfrog_gaussian at {(c, d, k)} disagrees with the "
                 f"plain version: q/p {err_qp}, logp {err_logp}")
        rows.append(row)
    return path_launches, rows


def check_model_on_card():
    """The compiled model on the card against the same model on the CPU,
    at 16 random flat points."""
    ir = bench.eight_schools_ir()
    gpu = compile_logp(ir, device="cuda")
    cpu = compile_logp(ir, device="cpu")
    flat = np.random.default_rng(7).uniform(-2, 2, size=(16, gpu.size))
    x = torch.as_tensor(flat, dtype=torch.float32)
    lg, gg = gpu.value_and_grad(x.cuda())
    lc, gc = cpu.value_and_grad(x)
    err = max(float((lg.cpu() - lc).abs().max()), float((gg.cpu() - gc).abs().max()))
    if err > 1e-3:
        fail(f"model value_and_grad on the card differs from the CPU by {err}")
    return err


def phase_main(num_warmup, num_samples):
    model_err = check_model_on_card()
    fused_leapfrog_gaussian.launches = 0
    res = bench.run(device="cuda", num_chains=1024, num_warmup=num_warmup,
                    num_samples=num_samples, num_superchains=32)
    main_launches = {"fused_leapfrog_gaussian": fused_leapfrog_gaussian.launches}
    det = res["detail"]
    out = {"phase": "main", "ess_per_s": res["value"], **det,
           "model_vs_cpu_max_abs_err": model_err,
           "kernel_launches": main_launches}
    emit(out)
    checks = [
        (abs(det["mu_mean"] - 4.4) < 0.3, "mu"),
        (abs(det["tau_mean"] - 3.6) < 0.3, "tau"),
        (det["nested_rhat_mu_k32"] < 1.01, "nested R-hat mu"),
        (det["nested_rhat_tau_k32"] < 1.01, "nested R-hat tau"),
        (det["divergence_rate"] < 2e-3, "divergence rate"),
        (np.isfinite(res["value"]), "ESS/s"),
    ]
    for ok, name in checks:
        if not ok:
            fail(f"main path: {name} out of bounds ({json.dumps(det)})")
    return main_launches


def phase_suite():
    """Every suite model under the recipe at full width, SUITE_ITERS
    iterations, one line per model; a model that breaks a gate fails the
    script after the phase. Returns the phase's kernel launches."""
    fused_leapfrog_gaussian.launches = 0
    failures = []
    for name in suite.MODELS:
        res = suite.run_checked(name, *SUITE_ITERS, device="cuda")
        emit({"phase": "suite", **res})
        if res["gate_failures"]:
            failures.append(f"{name}: {'; '.join(res['gate_failures'])}")
    launches = {"fused_leapfrog_gaussian": fused_leapfrog_gaussian.launches}
    if failures:
        fail("suite: " + " | ".join(failures))
    return launches


def phase_golds(workers=GOLD_WORKERS):
    """The 46 golds in a pool of ``workers`` processes, each taking the
    next gold, longest first; a gold that fails under the card recipe is
    run again here at the JAX battery's recipe. Returns the
    fused-leapfrog kernel's launches in the phase (each gold's read from
    its worker's counter around its run)."""
    t0 = time.perf_counter()
    names = validation.card_order(
        [validation.gold_name(m) for m in validation.all_gold_standards()])
    results, launches = [], 0
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        runs = pool.imap_unordered(validation.run_named_gold, names)
        for _ in names:
            res = runs.next(timeout=900)
            launches += res.pop("fused_leapfrog_gaussian_launches")
            results.append(res)
            # the per-parameter detail of a 1000-long path is not printed;
            # worst_mean_use and sd_ratio_range sum it up
            emit({"phase": "golds", **{k: v for k, v in res.items() if k != "params"}})
    failures, rerun = [], []
    for res in results:
        if res["compile_check"]["ok"] and res["gates_pass"]:
            continue
        if not res["compile_check"]["ok"]:
            failures.append(f"{res['model']}: compiled model differs from the CPU")
            continue
        again = validation.run_named_gold(res["model"], "jax", check_compile=False)
        launches += again.pop("fused_leapfrog_gaussian_launches")
        emit({"phase": "golds", "recipe": "jax",
              **{k: v for k, v in again.items() if k != "params"}})
        rerun.append(res["model"])
        if not again["gates_pass"]:
            failures.append(f"{res['model']}: {', '.join(again['gate_failures'])}")
    n = len(results)
    emit({"phase": "golds_summary", "n_pass": n - len(failures), "n": n,
          "seconds": time.perf_counter() - t0, "workers": workers,
          "card_recipe": validation.CARD_RECIPE,
          "card_overrides": validation.CARD_OVERRIDES,
          "rerun_at_jax_recipe": rerun,
          "fused_leapfrog_gaussian_launches": launches})
    if n != 46:
        fail(f"golds: {n} results, expected 46")
    if failures:
        fail("golds: " + " | ".join(failures))
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description="exmc_tpu_torch smoke run on one card")
    ap.add_argument("--warmup", type=int, default=200,
                    help="main-path warmup iterations (default 200)")
    ap.add_argument("--draws", type=int, default=500,
                    help="main-path draws (default 500)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": name, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    built = _build.build_all()
    for src, info in built.items():
        emit({"phase": "build", "source": f"exmc_tpu_torch/csrc/{src}.cu",
              "seconds": info["seconds"], "nvcc_log": info["log"]})

    path_launches, rows = phase_ops()
    if path_launches != len(OPS_SHAPES):
        fail(f"ops path launched the kernel {path_launches} times, "
             f"expected {len(OPS_SHAPES)}")
    main_launches = phase_main(args.warmup, args.draws)
    suite_launches = phase_suite()
    gold_launches = phase_golds()

    big = rows[-1]
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "fused_leapfrog_gaussian",
        "route": "cuda",
        "source": "exmc_tpu_torch/csrc/fused_leapfrog.cu",
        "replaces": "exmc_tpu/ops/fused_leapfrog.py:88",
        "launches": path_launches,
        "launches_path": "exmc_tpu_torch.ops.fused_leapfrog_gaussian at "
                         f"{len(OPS_SHAPES)} shapes",
        "main_path_launches": main_launches["fused_leapfrog_gaussian"],
        "suite_path_launches": suite_launches["fused_leapfrog_gaussian"],
        "gold_path_launches": gold_launches,
        "max_abs_err": max(r["max_abs_err_qp"] for r in rows),
        "shape_c_d_k": big["shape_c_d_k"],
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": None,
        "seconds_total": time.perf_counter() - t_start,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})


if __name__ == "__main__":
    main()
