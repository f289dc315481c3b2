"""Smoke run of exmc_tpu_torch on one CUDA card.

    python3 chip_smoke.py            # the full run: one card, no arguments

Phases, each printing JSON lines:
  1. device  — the card's name, the device count, nvidia-smi's name and
               power limit;
  2. build   — nvcc build of every source in exmc_tpu_torch/csrc, with
               its seconds and the -Xptxas -v report; then the native
               tree binding's g++ build (exmc_tpu_torch/native) and its
               lockstep with the card's masked tree on 300 trees of
               forced directions (native:lockstep);
  3. main    — the bench pipeline (eight schools, 1024 chains, superchain
               K=32, 200+500 iterations, pooled adaptation, ensemble
               rescue, max_depth 10) with its posterior checked against
               the statistical target, its leaves run by the leaf kernel
               (the run's ``leaf_kernel_leaves``), and the compiled model
               checked against the same model on the CPU;
  4. ops     — after the main path, since a profiler session can slow
               the process's later launches (PERF.md §7): the public op
               ``fused_leapfrog_gaussian`` held against its plain PyTorch
               version at four shapes and timed with CUDA events beside
               its bound, then driven once a shape under a profiler that
               counts its kernel's launches on the device; the
               Bernoulli-logit GLM kernel (``ops.glm_logit``) at
               covertype's shape, 64 chains x 581,012 rows x 54 columns,
               against its plain version in float64 (that call's launches
               counted the same way), timed beside its bound and the plain
               version in float32; the NUTS tree's leaf kernel
               (``nuts.leaf.LeafKernel``) against the plain leaf over eight
               leaves at eight schools' and covertype's (chains, d),
               1024 x 10 and 64 x 55, with its launches counted, and one
               launch timed beside its bound and the plain leaf's time;
  5. pool    — one spawn pool of POOL_WORKERS processes sharing the card,
               each taking the next task, longest first (POOL_COST_S):
               * suite: the seven-model suite under the JAX package's
                 recipe (chain counts, centered models, interweave and
                 gibbs_scales) at full width, one seed, SUITE_ITERS
                 iterations; one line per model, each held to its gates
                 (finite draws, split R-hat, divergence rate, posterior
                 means against the JAX package's), with the interweave
                 step and conditional metric run once under CUDA's sync
                 check;
               * golds: the JAX validation battery's 51 gold standards
                 (exmc_tpu_torch/benchmarks; five built through the Stan
                 frontend), each compiled on the card and held against the
                 CPU at 8 points, sampled under the card recipe at full
                 width and held to the battery's criterion, max split
                 R-hat and finite draws; a gold that fails only under the
                 card recipe is run again at the JAX battery's recipe;
               * entry: the remaining entry points
                 (exmc_tpu_torch/benchmarks/entry.py), one line per check:
                 the CLI (check, sample, summary as subprocesses on
                 stan_logistic_d21), run_chunked and a checkpoint resume
                 bit for bit equal to run, sample_stream in chunks and
                 every k draws, the data channel with a warm-started refit
                 through the sampler cache, and shared warmup;
               * engines: ChEES, SNAPER and MEADS on scaled32,
                 corrblock128 and eight schools at 1024 chains, 500
                 warmup + 500 draws (exmc_tpu_torch/benchmarks/engines.py),
                 one line per run with its gates; a MEADS run that falls
                 back from its Pathfinder init fails;
               * vi: the approximate engines on stan_logistic_d21 (the
                 CLI's optimize and variational as subprocesses; fit_map
                 on the card equal to the CPU's; Laplace with PSIR; ADVI
                 with SGD and Adam; Pathfinder diag, lowrank and lowrank
                 with PSIR), each held to the JAX package's result, and
                 NUTS from init="pathfinder" on the Stan eight-schools
                 NCP program;
               * post: post-processing, SMC, flows, evidence and SBC
                 (exmc_tpu_torch/benchmarks/post.py), one line per task:
                 SBC on normal_loc_scale with NUTS (R = 256), ChEES
                 (256 x 4) and MEADS (256 x 16) under the JAX package's
                 protocol and gates; the reliability example at full
                 settings (ADVI, Pathfinder, SMC, NUTS); flow_fit and
                 NeuTra on the centered funnel and the conjugate model;
                 the evidence by SMC and flow and a Bayes factor; the
                 predictive checks and WAIC/LOO/compare on a 256-chain
                 eight-schools trace, the card against the CPU; a
                 per-point det callable compiled on the card, graphed;
               * families: the model families
                 (exmc_tpu_torch/benchmarks/families.py), one line per
                 task at the examples' full widths (their NUTS runs cut
                 to half their iterations): sv_inla at T = 5000 in f64
                 against LONGT.json's row; the D-T39 logZ transect in
                 f32 and f64 with the marginal's value-and-grad times;
                 example 45 (INLA, then NUTS on the marginal in f64);
                 example 47 (AR(1) marginal, Kalman smoother); example 42
                 (HMM, smoothing, Viterbi); example 41 and the GLM tests'
                 four fits; example 13 (particle filter, PMMH) and SMC^2;
                 the exact-invariance battery on the card's tree (8192
                 chains);
               * stream: example 46 through sample_stream into a
                 LiveMonitor and a TraceStore, phase_report and
                 annotated_run under a profiler trace
                 (exmc_tpu_torch/benchmarks/parallel.py);
               * apps: the application layer
                 (exmc_tpu_torch/benchmarks/apps.py): example 06 at its
                 full settings and the two-player recipe of
                 tests/test_apps.py; the multi-table session (one
                 batched NUTS run over three tables); example 05's
                 inverse heat problem at full width, its NUTS run cut
                 to 16 chains of 30 + 20; and a fresh process running
                 eight schools twice (aot:cold_start), the first run's
                 excess being what a cache of compiled executables
                 could save;
               then one summary line each for the suite, the golds, the
               entry checks, the engines, the approximate engines, the
               post tasks, the families, the apps and the pool;
  6. parallel — started before the pool and joined after it (the pool's
               workers are daemonic and cannot start processes): a group
               of two gloo ranks sharing the card runs
               sample_chains_sharded on eight schools (1024 chains,
               200+500, pooled adaptation, ensemble rescue) with the
               sharded diagnostics against the host's, the data-parallel
               logistic regression at sp = 2 (n = 20,000, d = 21), the
               fault injector and the re-dispatch of a dead chain, and
               ChEES and SNAPER with mesh= (1024 chains, 500+500); one
               NCCL rank runs the collectives on CUDA tensors; one line
               per check and rank, then a summary with both walls;
  7. kernels — one JSON object with every kernel's numbers.
The last line is {"ok": true, "device": {...}}. Any failed check exits
non-zero before it. Without a CUDA card the script exits 2 at once.
"""

import argparse
import gc
import json
import multiprocessing
import multiprocessing.resource_tracker
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from exmc_tpu_torch import _build, compile_logp
from exmc_tpu_torch import bench
from exmc_tpu_torch.benchmarks import apps, engines, entry, families, post, suite, validation
from exmc_tpu_torch.benchmarks import parallel
from exmc_tpu_torch.nuts import leaf
from exmc_tpu_torch.nuts.leapfrog import kinetic_energy, make_metric
from exmc_tpu_torch.ops import glm_logit
from exmc_tpu_torch.ops.fused_leapfrog import (
    fused_leapfrog_gaussian,
    reference_leapfrog_gaussian,
)

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and
# f32 outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

OPS_SHAPES = [(8, 4, 16), (16, 128, 64), (1024, 256, 32), (8192, 256, 2048)]
# the GLM kernel's (chains, rows, columns): covertype's; each sum is held
# to GLM_TOL of the sum of the magnitudes it adds (float32 rounding grown
# by summation depth)
GLM_SHAPE = (64, 581_012, 54)
GLM_TOL = 1e-5
# the NUTS leaf kernel's (chains, d): eight schools' and covertype's cells
LEAF_SHAPES = [(1024, 10), (64, 55)]
OPS_EPS = 0.05
TOL_QP = 1e-4          # |kernel - plain| on q and p (same f32 steps, no FMA)
TOL_LOGP_ABS = 1e-3    # logp sums d terms in another order than torch.sum
TOL_LOGP_REL = 1e-5

# Suite phase: (warmup, draws) of every model, one seed. The JAX
# package's suite runs 1000+1000 x 5 seeds; 150 + 150 until the apps
# tasks joined the pool, cut to 120 + 120 to bring the script toward its
# 800 s budget (PERF.md, Findings).
SUITE_ITERS = (120, 120)

# Pool phase: worker processes sharing the card (one host sync per tree
# leaf; together they reach ~1,300-1,840 syncs/s whether 4, 6 or 8 run,
# PERF.md), each taking the next task, longest first.
POOL_WORKERS = 4
# Estimated seconds of the longest tasks in the pool: their host syncs in
# PR 3's card runs (the suite's at 150+150, the golds' under the card
# recipe) at ~2.3 ms a sync, the entry tasks' from their runs' sizes,
# the engine tasks' from their runs alone on the card, the post tasks'
# from their first run in the pool, the families tasks' from their first
# run in the pool scaled to their cut recipes, the apps tasks' from
# their first run in the pool (PERF.md, Findings).
# Only the order matters: the long tasks never start last.
POOL_COST_S = {
    ("suite", "eight_schools"): 200.0,
    ("families", "families:gp_glm"): 100.0,
    ("families", "families:sv_marginal"): 120.0,
    ("families", "families:ar_kalman"): 55.0,
    ("families", "families:particle"): 32.0,
    ("families", "families:hmm"): 18.0,
    ("families", "families:smoothness"): 15.0,
    ("families", "families:inla_t5000"): 10.0,
    ("families", "tree:invariance"): 2.0,
    ("post", "reliability"): 108.0,
    ("post", "flows"): 95.0,
    ("post", "sbc:normal_loc_scale"): 90.0,
    ("post", "sbc:chees_normal_loc_scale"): 24.0,
    ("post", "post"): 20.0,
    ("post", "sbc:meads_normal_loc_scale"): 18.0,
    ("post", "evidence"): 11.0,
    ("engines", "approx"): 40.0,
    ("engines", "eight_schools:chees"): 30.0,
    ("engines", "pathfinder_init"): 25.0,
    ("engines", "eight_schools:snaper"): 22.0,
    ("engines", "corrblock128:meads"): 10.0,
    ("engines", "scaled32:meads"): 10.0,
    ("engines", "eight_schools:meads"): 10.0,
    ("engines", "scaled32:snaper"): 8.0,
    ("engines", "corrblock128:snaper"): 8.0,
    ("engines", "corrblock128:chees"): 7.0,
    ("engines", "scaled32:chees"): 6.0,
    ("gold", "grw_kalman_t1000"): 114.0,
    ("entry", "chunked_stream"): 110.0,
    ("suite", "sv"): 95.0,
    ("gold", "radon_varying_intercept"): 68.0,
    ("gold", "kidiq_regression"): 51.0,
    ("gold", "crossed_random_effects_lmm"): 46.0,
    ("suite", "medium"): 45.0,
    ("entry", "cli"): 40.0,
    ("gold", "avtest_binomial_glmm"): 38.0,
    ("entry", "data_warm_start"): 30.0,
    ("gold", "ordered_normal_orderstats"): 27.0,
    ("gold", "eight_schools_ncp"): 25.0,
    ("gold", "stan_eight_schools"): 25.0,
    ("gold", "stan_eight_schools_ncp"): 25.0,
    ("gold", "mvn_dense_mass"): 24.0,
    ("suite", "simple"): 22.0,
    ("suite", "logistic"): 21.0,
    ("suite", "funnel"): 20.0,
    ("suite", "stress"): 17.0,
    ("entry", "shared_warmup"): 15.0,
    ("parallel", "stream:example46"): 40.0,
    ("apps", "apps:poker"): 240.0,
    ("apps", "apps:physics"): 120.0,
    ("apps", "apps:poker_multitable"): 95.0,
    ("apps", "aot:cold_start"): 25.0,
}
N_GOLDS = 51
N_ENGINE_ROWS = 9        # three engines on three models
N_VI_ROWS = 11           # the CLI, 3 fit_map, laplace, 2 ADVI, 3 Pathfinder, the init
N_POST_ROWS = len(post.TASKS)
N_FAMILIES_ROWS = len(families.TASKS)
N_APPS_ROWS = len(apps.TASKS)
# the parallel phase: a line per group check and rank, the NCCL rank's
# line, the stream line
N_PARALLEL_ROWS = len(parallel.GROUP_TASKS) * parallel.GROUP_SIZE + 2
# deadline of the parallel ranks, which run alongside the pool
PARALLEL_TIMEOUT_S = 1000.0


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


def stop_children(wait_s=30.0):
    """Stop multiprocessing's resource tracker and wait for it (left
    alone, it exits after this process and stays a zombie until init
    reaps it), then return the pids of this process's children still
    running after up to ``wait_s`` seconds; exited ones are reaped."""
    gc.collect()  # a dead pool's semaphores unregister before the tracker stops
    multiprocessing.resource_tracker._resource_tracker._stop()
    deadline = time.monotonic() + wait_s
    while True:
        running = []
        for pid in filter(str.isdigit, os.listdir("/proc")):
            try:
                with open(f"/proc/{pid}/stat", encoding="ascii") as f:
                    state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            except (OSError, ValueError):
                continue
            if int(ppid) != os.getpid():
                continue
            if state == "Z":
                os.waitpid(int(pid), os.WNOHANG)
            else:
                running.append(int(pid))
        if not running or time.monotonic() >= deadline:
            return running
        time.sleep(0.5)


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


def device_profile():
    """A ``torch.profiler`` session that records the card's kernels."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def kernel_events(prof, name):
    """The device events of a finished ``device_profile`` session whose
    kernel's name holds ``name``."""
    from torch.autograd import DeviceType

    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and name in e.name()]


def phase_ops():
    """Compare and time each shape, then drive the op's path once a shape
    under a profiler. Returns (the kernel's launches on the device in that
    drive, the rows)."""
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

    with device_profile() as prof:
        for i, (c, d, k) in enumerate(OPS_SHAPES):
            q, p, mu, prec, inv = leapfrog_inputs(c, d, i)
            qf, pf, lf = fused_leapfrog_gaussian(q, p, mu, prec, inv, OPS_EPS, k)
            torch.cuda.synchronize()
            if qf.shape != (c, d) or lf.shape != (c,) or not bool(
                    torch.isfinite(qf).all() & torch.isfinite(pf).all()
                    & torch.isfinite(lf).all()):
                fail(f"fused_leapfrog_gaussian at {(c, d, k)}: bad output")
    return len(kernel_events(prof, "fused_leapfrog_kernel")), rows


def phase_glm_kernel():
    """The GLM likelihood kernel at covertype's shape against its plain
    version in float64, with that call's launches of the kernel counted on
    the device, and its time beside its bound and the plain version's in
    float32."""
    t0 = time.perf_counter()
    c, n, d = GLM_SHAPE
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(n, d, generator=g, device="cuda")
    y = (torch.rand(n, generator=g, device="cuda") < 0.5).float()
    beta = torch.randn(c, d, generator=g, device="cuda") * 0.2
    b0 = torch.randn(c, generator=g, device="cuda") * 0.2
    with device_profile() as prof:
        lp, g_beta, g_b0 = glm_logit.glm_logit_value_and_grad(x, y, beta, b0)
        torch.cuda.synchronize()
    launches = len(kernel_events(prof, "glm_logit_partials"))
    x64, y64, beta64, b064 = x.double(), y.double(), beta.double(), b0.double()
    want = glm_logit.glm_logit_plain(x64, y64, beta64, b064)
    eta = beta64 @ x64.T + b064[:, None]
    terms = (y64 * eta - torch.logaddexp(torch.zeros_like(eta), eta)).abs().sum(-1)
    r = (y64 - torch.sigmoid(eta)).abs()
    err = {"lp": float(((lp.double() - want[0]).abs() / terms).max()),
           "g_beta": float(((g_beta.double() - want[1]).abs() / (r @ x64.abs())).max()),
           "g_b0": float(((g_b0.double() - want[2]).abs() / r.sum(-1)).max())}
    del eta, r
    kernel_ms = time_cuda(lambda: glm_logit.glm_logit_value_and_grad(x, y, beta, b0), reps=50)
    plain_ms = time_cuda(lambda: glm_logit.glm_logit_plain(x, y, beta, b0), reps=5, warmup=1)
    t_ops = 4.0 * n * d * c / PEAK_F32_OPS_S * 1e3
    t_bytes = 4.0 * n * (d + 1) / PEAK_BYTES_S * 1e3
    row = {"shape_c_n_d": list(GLM_SHAPE), "max_rel_err": err, "ms": kernel_ms,
           "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "share_of_bound": max(t_ops, t_bytes) / kernel_ms, "library_ms": None,
           "launches": launches,
           "seconds": time.perf_counter() - t0}
    emit({"phase": "ops", "kernel": "glm_logit", **row})
    if not max(err.values()) <= GLM_TOL:
        fail(f"glm_logit at {GLM_SHAPE} disagrees with the plain version: {err}")
    if launches != 1:
        fail(f"glm_logit: one call launched the kernel {launches} times")
    return row


def leaf_inputs(c, d, seed):
    """A subtree's start at (c, d) in float32 on a standard normal target,
    per-chain inverse masses in [0.5, 2], and its value-and-grad."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    metric = make_metric(0.5 + 1.5 * torch.rand(c, d, generator=g, device="cuda"))
    z0 = torch.randn(c, d, generator=g, device="cuda")
    r0 = torch.randn(c, d, generator=g, device="cuda") / metric.chol_inv

    def vag(q):
        return -0.5 * torch.sum(q * q, dim=-1), -q

    logp0, g0 = vag(z0)
    joint0 = logp0 - kinetic_energy(metric, r0)
    eps = (0.2 + 0.6 * torch.rand(c, generator=g, device="cuda"))[:, None]
    logu = -torch.empty(c, 8, device="cuda").exponential_(generator=g)
    active = torch.ones(c, dtype=torch.bool, device="cuda")
    return vag, metric, eps, z0, r0, g0, joint0, logu, active


def time_leaf_step(k, logp, g, reps=200):
    """(median device ms of one launch of odd leaf 7 from the profiler's
    kernel events, mean ms between CUDA events recorded around each
    launch, which adds the launch's path from the host); every chain is
    set live before each launch."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda.synchronize()
    with device_profile() as prof:
        for e0, e1 in zip(starts, ends):
            k.live.fill_(True)
            e0.record()
            k.step(7, logp, g, has_next=True)
            e1.record()
        torch.cuda.synchronize()
    device_ns = [e.duration_ns() for e in kernel_events(prof, "leaf_step")]
    issue_ms = float(np.mean([a.elapsed_time(b) for a, b in zip(starts, ends)][10:]))
    return (float(np.median(device_ns)) / 1e6 if device_ns else None), issue_ms


def phase_leaf_kernel():
    """The NUTS tree's leaf kernel against the plain leaf at eight
    schools' and covertype's (chains, d): leaves 0..7 of one subtree, each
    from the kernel's state before it. The fields no dot product feeds
    must be bit-equal, the masks equal; joint and lsw lie within 4 d ulps
    of the magnitudes the kinetic energy adds. Then one launch of an odd
    leaf that checks three slots, timed beside its bound and the plain
    leaf's time (``time_leaf_step``). The start and the eight leaves run
    under a profiler, which counts their launches on the device."""
    t0 = time.perf_counter()
    rows = []
    for i, (c, d) in enumerate(LEAF_SHAPES):
        vag, metric, eps, z0, r0, g0, joint0, logu, active = leaf_inputs(c, d, 21 + i)
        with device_profile() as prof:
            k = leaf.LeafKernel(metric, eps, z0, r0, g0, joint0, logu, active, 5)
            exact, worst = True, 0.0
            for n in range(8):
                st = leaf.Subtree(*(t.clone() for t in k.subtree()))
                ckpt, live = k.ckpt.clone(), k.live.clone()
                want = leaf.leaf_plain(vag, metric, eps, n, st, joint0, logu[:, n], live, ckpt, 5)
                k.step(n, *vag(k.z_in), has_next=n < 7)
                got = k.subtree()
                for name in ("n", "z", "r", "g", "r_first", "z_prop", "logp_prop", "g_prop", "rho",
                             "turning", "diverging"):
                    exact &= torch.equal(getattr(got, name), getattr(want, name))
                exact &= torch.equal(k.ckpt, ckpt) and torch.equal(
                    k.live, active & ~want.turning & ~want.diverging)
                bound = 4 * d * torch.finfo(torch.float32).eps * (
                    1 + joint0.abs() + want.joint_prop.abs() + kinetic_energy(metric, want.r))
                for name in ("joint_prop", "lsw"):
                    a, b = getattr(got, name), getattr(want, name)
                    err = torch.where(a == b, 0.0, (a - b).abs() / bound)
                    worst = max(worst, float(torch.nan_to_num(err, nan=np.inf).max()))
            torch.cuda.synchronize()
        launches = {name: len(kernel_events(prof, name)) for name in ("leaf_start", "leaf_step")}
        logp, g = vag(k.z_in)
        kernel_ms, issue_ms = time_leaf_step(k, logp, g)
        st = leaf.Subtree(*(t.clone() for t in k.subtree()))
        live = torch.ones(c, dtype=torch.bool, device="cuda")
        plain_ms = time_cuda(lambda: leaf.leaf_plain(lambda q: (logp, g), metric, eps, 7, st,
                                                     joint0, logu[:, 7], live, k.ckpt, 5),
                             reps=50)
        # each (C, d) value read or written once: p_half, g, z_in, r, rho in;
        # z, r, g, rho, p_half, z_in, z_prop, g_prop out; 3 slots x 3 rows
        # of checkpoints in; and ~12 per-chain scalars
        nbytes = 4 * c * (d * (13 + 9) + 12)
        bound_ms = nbytes / PEAK_BYTES_S * 1e3
        row = {"shape_c_d": [c, d], "bit_equal": exact, "max_err_over_bound": worst,
               "ms": kernel_ms, "issue_ms": issue_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
               "share_of_bound": bound_ms / kernel_ms if kernel_ms else None, "library_ms": None,
               "launches": launches}
        emit({"phase": "ops", "kernel": "nuts_leaf", **row})
        if not exact or not worst <= 1.0:
            fail(f"nuts_leaf at {(c, d)} disagrees with the plain leaf: {row}")
        if launches != {"leaf_start": 1, "leaf_step": 8}:
            fail(f"nuts_leaf at {(c, d)}: the start and eight leaves launched {launches}")
        rows.append(row)
    return {"rows": rows, "seconds": time.perf_counter() - t0}


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
    res = bench.run(device="cuda", num_chains=1024, num_warmup=num_warmup,
                    num_samples=num_samples, num_superchains=32)
    det = res["detail"]
    emit({"phase": "main", "ess_per_s": res["value"], **det,
          "model_vs_cpu_max_abs_err": model_err})
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
    if det["leaf_kernel_leaves"] == 0:
        fail("main path: the NUTS leaf kernel never ran")
    return det["leaf_kernel_leaves"]


def pool_tasks():
    """Every task of the pool phase, longest first by POOL_COST_S, the
    rest in suite, battery and entry order."""
    tasks = ([("suite", m) for m in suite.MODELS]
             + [("gold", validation.gold_name(m)) for m in validation.all_gold_standards()]
             + [("entry", t) for t in entry.TASKS]
             + [("engines", t) for t in engines.TASKS]
             + [("post", t) for t in post.TASKS]
             + [("families", t) for t in families.TASKS]
             + [("apps", t) for t in apps.TASKS]
             + [("parallel", "stream:example46")])
    return sorted(tasks, key=lambda t: -POOL_COST_S.get(t, 0.0))


PHASE_OF = {"suite": "suite", "gold": "golds", "entry": "entry", "engines": "engines",
            "post": "post", "families": "families", "parallel": "parallel", "apps": "apps"}
POOL_PHASES = ("suite", "golds", "entry", "engines", "vi", "post", "families", "parallel",
               "apps")


def run_task(task):
    """One pool task in a worker process: a list of JSON lines. A task
    that raises returns one line with the error, reported after the
    pool."""
    kind, name = task
    try:
        return _run_task(kind, name)
    except Exception:  # noqa: BLE001 - every task's fault is reported
        phase = "vi" if name in ("approx", "pathfinder_init") else PHASE_OF[kind]
        return [{"phase": phase, "task": name, "error": traceback.format_exc()[-3000:]}]


def _run_task(kind, name):
    if kind == "gold":
        res = validation.run_named_gold(name)
        # the per-parameter detail of a 1000-long path is not printed;
        # worst_mean_use and sd_ratio_range sum it up
        return [{"phase": "golds", **{k: v for k, v in res.items() if k != "params"}}]
    if kind == "suite":
        return [{"phase": "suite", **suite.run_checked(name, *SUITE_ITERS, device="cuda")}]
    if kind in ("engines", "post", "families", "parallel", "apps"):
        module = {"engines": engines, "post": post, "families": families,
                  "parallel": parallel, "apps": apps}[kind]
        return [{"task": name, **res} for res in module.run_task(name, "cuda")]
    return [{"phase": "entry", **res} for res in entry.run_check(name, "cuda")]


def phase_pool(workers=POOL_WORKERS):
    """The suite, the golds and the entry checks in a pool of ``workers``
    processes, each taking the next task, longest first; a gold that
    fails under the card recipe is run again here at the JAX battery's
    recipe. Returns the parallel phase's lines (the stream task's)."""
    t0 = time.perf_counter()
    tasks = pool_tasks()
    lines = []
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        runs = pool.imap_unordered(run_task, tasks)
        for _ in tasks:
            for line in runs.next(timeout=900):
                emit(line)
                lines.append(line)
    seconds = time.perf_counter() - t0
    by_phase = {p: [x for x in lines if x["phase"] == p] for p in POOL_PHASES}
    failures = {p: [f"{x['task']}: {x['error']}" for x in xs if "error" in x]
                for p, xs in by_phase.items()}
    by_phase = {p: [x for x in xs if "error" not in x] for p, xs in by_phase.items()}
    n_errors = {p: len(f) for p, f in failures.items()}

    for res in by_phase["suite"]:
        if res["gate_failures"]:
            failures["suite"].append(f"{res['model']}: {'; '.join(res['gate_failures'])}")
    n_suite = len(by_phase["suite"]) + n_errors["suite"]
    emit({"phase": "suite_summary", "n_pass": n_suite - len(failures["suite"]),
          "n": n_suite})

    rerun = []
    for res in by_phase["golds"]:
        if res["compile_check"]["ok"] and res["gates_pass"]:
            continue
        if not res["compile_check"]["ok"]:
            failures["golds"].append(f"{res['model']}: compiled model differs from the CPU")
            continue
        again = validation.run_named_gold(res["model"], "jax", check_compile=False)
        emit({"phase": "golds", "recipe": "jax",
              **{k: v for k, v in again.items() if k != "params"}})
        rerun.append(res["model"])
        if not again["gates_pass"]:
            failures["golds"].append(f"{res['model']}: {', '.join(again['gate_failures'])}")
    n = len(by_phase["golds"]) + n_errors["golds"]
    emit({"phase": "golds_summary", "n_pass": n - len(failures["golds"]), "n": n,
          "card_recipe": validation.CARD_RECIPE,
          "card_overrides": validation.CARD_OVERRIDES,
          "rerun_at_jax_recipe": rerun})

    for res in by_phase["entry"]:
        if not res["ok"]:
            failures["entry"].append(f"{res['check']}: {'; '.join(res['failures'])}")
    n_entry = len(by_phase["entry"]) + n_errors["entry"]
    emit({"phase": "entry_summary", "n_pass": n_entry - len(failures["entry"]),
          "n": n_entry})

    for p in ("engines", "vi", "post", "families", "parallel", "apps"):
        for res in by_phase[p]:
            if not res["ok"]:
                name = res.get("check") or f"{res['model']}:{res['engine']}"
                failures[p].append(f"{name}: {'; '.join(res['failures'])}")
    eng = by_phase["engines"]
    n_eng = len(eng) + n_errors["engines"]
    emit({"phase": "engines_summary", "n_pass": n_eng - len(failures["engines"]),
          "n": n_eng, "gated": sum(r["gated"] for r in eng),
          "rows": [{k: r.get(k) for k in ("model", "engine", "wall_s", "min_ess",
                                          "min_ess_per_s", "max_rhat", "syncs_per_iter",
                                          "num_steps_mean", "peak_mb", "ok")}
                   for r in eng]})
    n_vi = len(by_phase["vi"]) + n_errors["vi"]
    emit({"phase": "vi_summary", "n_pass": n_vi - len(failures["vi"]), "n": n_vi})
    rows = by_phase["post"]
    n_post = len(rows) + n_errors["post"]
    emit({"phase": "post_summary", "n_pass": n_post - len(failures["post"]), "n": n_post,
          "sbc": [{k: r.get(k) for k in ("check", "R", "L", "min_p", "min_ecdf_p",
                                         "divergence_rate", "host_syncs", "wall_s",
                                         "peak_mb", "jax_reference_tpu", "ok")}
                  for r in rows if r["check"].startswith("sbc:")]})
    rows = by_phase["families"]
    n_fam = len(rows) + n_errors["families"]
    emit({"phase": "families_summary", "n_pass": n_fam - len(failures["families"]),
          "n": n_fam,
          "tasks": [{k: r.get(k) for k in ("check", "wall_s", "host_syncs", "peak_mb", "ok")}
                    for r in rows]})
    rows = by_phase["apps"]
    n_apps = len(rows) + n_errors["apps"]
    emit({"phase": "apps_summary", "n_pass": n_apps - len(failures["apps"]), "n": n_apps,
          "tasks": [{k: r.get(k) for k in ("check", "wall_s", "host_syncs", "peak_mb", "ok")}
                    for r in rows]})
    emit({"phase": "pool_summary", "seconds": seconds, "workers": workers,
          "tasks": len(tasks)})

    if n != N_GOLDS:
        fail(f"golds: {n} results, expected {N_GOLDS}")
    if n_suite != len(suite.MODELS):
        fail(f"suite: {n_suite} results, expected {len(suite.MODELS)}")
    for p, fs in failures.items():
        if fs:
            fail(f"{p}: " + " | ".join(fs))
    if (n_eng != N_ENGINE_ROWS or n_vi != N_VI_ROWS or n_post != N_POST_ROWS
            or n_fam != N_FAMILIES_ROWS or n_apps != N_APPS_ROWS):
        fail(f"engines/vi/post/families/apps: {n_eng}, {n_vi}, {n_post}, {n_fam} and "
             f"{n_apps} results, expected {N_ENGINE_ROWS}, {N_VI_ROWS}, {N_POST_ROWS}, "
             f"{N_FAMILIES_ROWS} and {N_APPS_ROWS}")
    return by_phase["parallel"]


def start_parallel(workdir):
    """Start the parallel phase's ranks: the group of two gloo ranks on
    the card and the one-rank NCCL group."""
    group = parallel.start_ranks(
        parallel.group_main, parallel.GROUP_SIZE,
        (parallel.GROUP_TASKS, parallel.FULL, "cuda"),
        workdir=f"{workdir}/group", timeout_s=PARALLEL_TIMEOUT_S)
    nccl = parallel.start_ranks(parallel.nccl_main, 1, (parallel.FULL, "cuda"),
                                backend="nccl", workdir=f"{workdir}/nccl",
                                timeout_s=PARALLEL_TIMEOUT_S)
    return group, nccl


def phase_parallel(group, nccl, pool_lines):
    """Join the ranks, print their lines and the phase's summary with
    ``pool_lines`` (the stream task's)."""
    lines = []
    for run in (group, nccl):
        try:
            per_rank = run.wait()
        except Exception:  # noqa: BLE001 - a failed rank fails the phase
            fail(f"parallel ranks: {traceback.format_exc()[-3000:]}")
        lines += [{"phase": "parallel", **res} for res in sum(per_rank, [])]
    for line in lines:
        emit(line)
    lines += pool_lines
    failures = [f"{x['check']}: {'; '.join(x['failures'])}" for x in lines if not x["ok"]]
    by_check = {}
    for x in lines:
        by_check.setdefault(x["check"], []).append(x)
    es = by_check.get("parallel:eight_schools_dp2", [])
    emit({"phase": "parallel_summary", "n_pass": len(lines) - len(failures),
          "n": len(lines), "group_seconds": group.seconds, "nccl_seconds": nccl.seconds,
          "eight_schools_dp2": [{k: x.get(k) for k in ("rank", "wall_s", "host_syncs",
                                                        "host_staged_collectives",
                                                        "peak_mb", "chain_ok")}
                                for x in es]})
    if failures:
        fail("parallel: " + " | ".join(failures))
    if len(lines) != N_PARALLEL_ROWS:
        fail(f"parallel: {len(lines)} results, expected {N_PARALLEL_ROWS}")


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
    lockstep = apps.check_native_lockstep("cuda")
    emit({"phase": "build", **lockstep})
    if not lockstep["ok"]:
        fail(f"native:lockstep: {'; '.join(lockstep['failures'])}")

    main_leaves = phase_main(args.warmup, args.draws)
    # after the main path: the kernels' checks count launches under a
    # profiler session, which can slow this process's later launches
    # (PERF.md §7)
    path_launches, rows = phase_ops()
    if path_launches != len(OPS_SHAPES):
        fail(f"ops path launched the kernel {path_launches} times, "
             f"expected {len(OPS_SHAPES)}")
    glm_row = phase_glm_kernel()
    leaf_rows = phase_leaf_kernel()
    with tempfile.TemporaryDirectory() as workdir:
        group, nccl = start_parallel(workdir)
        try:
            phase_parallel(group, nccl, phase_pool())
        finally:
            group.kill()
            nccl.kill()
            parallel.stop_rank_server()
    stray = stop_children()
    if stray:
        fail(f"processes still running at the end: {stray}")

    big = rows[-1]
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "fused_leapfrog_gaussian",
        "route": "cuda",
        "source": "exmc_tpu_torch/csrc/fused_leapfrog.cu",
        "replaces": "exmc_tpu/ops/fused_leapfrog.py:88",
        "launches": path_launches,
        "launches_path": "exmc_tpu_torch.ops.fused_leapfrog_gaussian at "
                         f"{len(OPS_SHAPES)} shapes, one call each",
        "max_abs_err": max(r["max_abs_err_qp"] for r in rows),
        "shape_c_d_k": big["shape_c_d_k"],
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": None,
    }, {
        "name": "glm_logit",
        "route": "cuda",
        "source": "exmc_tpu_torch/csrc/glm_logit.cu",
        "replaces": None,
        "launches_path": "exmc_tpu_torch.ops.glm_logit at covertype's shape, one call",
        **glm_row,
    }, {
        "name": "nuts_leaf",
        "route": "cuda",
        "source": "exmc_tpu_torch/csrc/nuts_leaf.cu",
        "replaces": None,
        "launches_path": "exmc_tpu_torch.nuts.leaf.LeafKernel at "
                         f"{len(LEAF_SHAPES)} shapes, 8 leaves each",
        "main_path_leaf_kernel_leaves": main_leaves,
        **leaf_rows,
    }], "seconds_total": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})


if __name__ == "__main__":
    main()
