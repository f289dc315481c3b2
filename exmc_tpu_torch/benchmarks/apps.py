"""The application layer driven on one device: the ``apps`` tasks of
``chip_smoke.py`` (examples 05 and 06 and the multi-table session), the
native tree binding's lockstep with the device's masked tree, and the
cold start that a persistent executable cache could save. Each check
returns one dict with ``ok``, the list of ``failures`` and what it
measured (wall seconds, host syncs, peak device memory); the tests run
the same code on the CPU at small sizes.

* ``apps:poker`` (``check_poker``): example 06 at its settings (the
  first three archetypes, 80 hands, seed 0; ``profile`` with 400 warmup
  + 400 draws, seed 42; ``decide`` on Ah Kh against Td Jd 2c, pot 100,
  to call 30), then ``tests/test_apps.py``'s two-player recipe (nit and
  maniac, 80 hands, seed 1, 300 + 200, seed 42). Gates: the simulated
  observations equal the JAX package's bit for bit (``EX06_OBS_SHA256``);
  finite draws and divergences under 1 % of draws; each player's
  posterior vpip mean within ``VPIP_TOL`` of the JAX package's range
  (``EX06_VPIP_JAX``); ``recommended`` one of fold, call, raise, and the
  equity equal to the JAX package's; the compiled model on the device
  against the CPU at 8 points (``REL_VALUE``, ``REL_GRAD``); the
  two-player run's nit vpip below the maniac's and ``compare``'s first
  row the nit.
* ``apps:poker_multitable`` (``check_poker_multitable``):
  ``MultiTable(num_tables=3, seed=0).play(hands=60).profile_all(
  num_warmup=300, num_samples=200, seed=1)``, one batched NUTS run over
  all tables (``tests/test_apps.py``'s recipe). Gates: lag vpip above
  nit vpip at every table, 3 x 3 finite profiles; the batched
  log-density on the device equal to the sum of the per-table
  ``build`` log-densities at 8 points, at T = P = 3 and at T = 4, P = 3
  (``REL_VALUE``).
* ``apps:physics`` (``check_physics``): example 05's inverse model at
  full width (10 x 10 grid, 30 Jacobi iterations, noise 0.02, lam 2.0,
  the example's data) at a cut depth: 16 chains, 30 warmup + 20 draws,
  max depth 10 (the example's one chain of 500 + 500 saturates the tree
  at every iteration, ~1M host syncs). The example reads its sensors on
  the bottom row, which the Dirichlet boundary holds at ``bc_bottom``:
  its forward map is constant in phi, the data carry no information, and
  its posterior is the Laplacian prior alone. So the solve is also held
  on the device against the CPU through the same model with its sensors
  on the row above (interior cells, ``interior_sensors``). Gates: each
  compiled model on the device against the CPU (the example's at 8
  points, the interior one's at one point a chain); finite draws; the share of draws
  at depth 10 and the mean final step size within the JAX package's
  range at this recipe over four seeds (``PHYSICS_JAX``), widened by 0.1
  on the share and a factor of 2 on the step size. The inferred void
  fraction is printed beside the truth (0.16), not gated.
* ``native:lockstep`` (``check_native_lockstep``): the port's native
  tree binding (built with g++) against the device's masked tree on
  ``tests/test_torch_tree_oracle.py``'s forced-direction protocol
  (300 trees, seeded draws injected): equal depth, leapfrog count and
  divergence on every tree, accept statistic within 5e-4.
* ``aot:cold_start`` (``check_cold_start``): a fresh process imports the
  port and runs eight schools (1024 chains, 20 + 20) twice; the first
  run's excess over the second bounds what a cache of compiled
  executables across processes could save.

    python -m exmc_tpu_torch.benchmarks.apps [--task TASK ...] [--device cpu]
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from exmc_tpu_torch import native
from exmc_tpu_torch.apps import physics, poker
from exmc_tpu_torch.apps.poker import opponent_model
from exmc_tpu_torch.benchmarks import validation
from exmc_tpu_torch.benchmarks.families import _Measure, _result
from exmc_tpu_torch.compiler import compile_logp
from exmc_tpu_torch.config import prepare_device
from exmc_tpu_torch.nuts import sampler as _sampler
from exmc_tpu_torch.nuts.leapfrog import make_metric
from exmc_tpu_torch.nuts.tree import nuts_transition

TASKS = ["apps:poker", "apps:poker_multitable", "apps:physics", "aot:cold_start"]
NATIVE_TASK = "native:lockstep"

# Example 06 (examples/06_poker.py) at its full settings, and
# tests/test_apps.py's two-player recipe.
EX06 = {"players": 3, "hands": 80, "sim_seed": 0, "warmup": 400, "draws": 400,
        "seed": 42, "hole": ["Ah", "Kh"], "board": ["Td", "Jd", "2c"], "pot": 100,
        "to_call": 30}
TWO_PLAYER = {"archetypes": [2, 4], "hands": 80, "sim_seed": 1, "warmup": 300,
              "draws": 200, "seed": 42}
MULTITABLE = {"tables": 3, "hands": 60, "seed": 0, "warmup": 300, "draws": 200,
              "nuts_seed": 1}
# Example 05 (examples/05_physics_inversion.py) at full width; its NUTS
# run (1 chain, 500 + 500) cut to 16 chains of 30 + 20.
PHYSICS = {"ny": 10, "nx": 10, "iterations": 30, "noise_sigma": 0.02, "lam": 2.0,
           "chains": 16, "warmup": 30, "draws": 20, "max_tree_depth": 10, "seed": 0}
PHYSICS_REDUCED = ("NUTS: 16 chains, 30 warmup + 20 draws, max depth 10 "
                   "(example 05: 1 chain, 500 + 500)")

# The JAX package on the CPU, recorded by `JAX_PLATFORMS=cpu python
# tests/test_torch_apps_refs.py` (which prints these constants):
# the sha256 of example 06's simulated hand strengths (float64) and
# actions (int64); the decision's equity; each player's posterior vpip
# mean at example 06's settings, min and max over NUTS seeds 42-45; the
# share of draws at depth 10 and the mean final step size at the
# PHYSICS recipe, min and max over seeds 0-3 (every draw of every seed
# at depth 10; the inferred void fraction 0.30-0.53 against a true 0.16).
EX06_OBS_SHA256 = "51bfbb6c31a27d3ebdcbb39a4f9a6ede83b6bbd3ca50d4f6f69742d30e21bb31"
EX06_EQUITY_JAX = 0.59
EX06_VPIP_JAX = {"tag": (0.2735501527786255, 0.28422972559928894),
                 "lag": (0.3346744477748871, 0.34906265139579773),
                 "nit": (0.2796943485736847, 0.28584423661231995)}
PHYSICS_JAX = {"max_depth_share": (1.0, 1.0),
               "step_size": (0.06306720525026321, 0.06799281388521194)}
VPIP_TOL = 0.08
REL_VALUE = 1e-5
REL_GRAD = 1e-4
DEPTH_SHARE_TOL = 0.1
STEP_SIZE_FACTOR = 2.0


def _last_run_syncs():
    """Host syncs of the run that the last ``sample`` call made: its
    sampler is the sampler cache's most recent entry."""
    return next(reversed(_sampler._SAMPLER_CACHE.values())).last_run["host_syncs"]


def obs_digest(observations):
    """sha256 of the hand strengths (float64) and actions (int64) of
    every player, in order."""
    h = hashlib.sha256()
    for o in observations:
        h.update(np.asarray(o["hand_strengths"], np.float64).tobytes())
        h.update(np.asarray(o["actions"], np.int64).tobytes())
    return h.hexdigest()


def compile_check(ir, dev, ncp=False, n_points=8):
    """The compiled model on ``dev`` against the CPU at ``n_points``
    seeded flat points (``validation.compile_check``): the worst value
    and gradient errors, each relative to max(1, the CPU's magnitude) at
    its point."""
    _, e_value, e_grad = validation.compile_check(SimpleNamespace(ir=ir, ncp=ncp), dev,
                                                  n_points=n_points)
    return {"value_rel_err": e_value, "grad_rel_err": e_grad}


def _compile_fails(name, err):
    fails = []
    if not err["value_rel_err"] <= REL_VALUE:
        fails.append(f"{name}: value on the device off the CPU's by {err['value_rel_err']:.3g}")
    if not err["grad_rel_err"] <= REL_GRAD:
        fails.append(f"{name}: gradient on the device off the CPU's by "
                     f"{err['grad_rel_err']:.3g}")
    return fails


def _finite(profiles):
    return all(np.isfinite(v).all() for p in profiles for v in p.values())


def check_poker(device="cuda", ex06=EX06, two=TWO_PLAYER):
    """Example 06, then the two-player recipe."""
    dev = prepare_device(device)
    players = poker.archetypes()[:ex06["players"]]
    obs, truth = poker.simulate(players, hands=ex06["hands"], seed=ex06["sim_seed"])
    err = compile_check(opponent_model.build(obs), dev)
    with _Measure(dev) as meas:
        profiles, stats = poker.profile(obs, num_samples=ex06["draws"],
                                        num_warmup=ex06["warmup"], seed=ex06["seed"],
                                        device=dev)
        syncs = _last_run_syncs()
    d = poker.decide(ex06["hole"], ex06["board"], profiles[0], pot=ex06["pot"],
                     to_call=ex06["to_call"])
    rows = poker.compare(truth, profiles)
    vpip = {r["player"]: float(np.mean(p["vpip"])) for r, p in zip(rows, profiles)}
    n_draws = int(stats["diverging"].size)
    out = {"players": [r["player"] for r in rows], "hands": ex06["hands"],
           "iters": [ex06["warmup"], ex06["draws"]], "obs_sha256": obs_digest(obs),
           "compare": rows, "vpip_mean": vpip, "vpip_jax": EX06_VPIP_JAX,
           "divergences": int(stats["divergences"].sum()),
           "depth_mean": float(stats["depth"].mean()),
           "step_size": float(np.mean(stats["step_size"])),
           "decision": {k: d[k] for k in ("equity", "call", "raise", "recommended")},
           "equity_jax": EX06_EQUITY_JAX, "compile_check": err, "host_syncs": syncs,
           "wall_s": meas.wall_s, "peak_mb": meas.peak_mb}
    fails = _compile_fails("example 06 model", err)
    if EX06_OBS_SHA256 is not None and out["obs_sha256"] != EX06_OBS_SHA256:
        fails.append("simulated observations differ from the JAX package's")
    if not _finite(profiles):
        fails.append("non-finite draws")
    if not out["divergences"] < 0.01 * n_draws:
        fails.append(f"{out['divergences']} divergences in {n_draws} draws")
    if EX06_VPIP_JAX is not None:
        for name, (lo, hi) in EX06_VPIP_JAX.items():
            if not lo - VPIP_TOL <= vpip[name] <= hi + VPIP_TOL:
                fails.append(f"{name} vpip {vpip[name]:.3f} outside JAX's "
                             f"[{lo:.3f}, {hi:.3f}] +- {VPIP_TOL}")
    if d["recommended"] not in ("fold", "call", "raise"):
        fails.append(f"recommended {d['recommended']!r}")
    if EX06_EQUITY_JAX is not None and d["equity"] != EX06_EQUITY_JAX:
        fails.append(f"equity {d['equity']} != JAX's {EX06_EQUITY_JAX}")

    pair = [poker.archetypes()[i] for i in two["archetypes"]]
    obs2, truth2 = poker.simulate(pair, hands=two["hands"], seed=two["sim_seed"])
    with _Measure(dev) as meas2:
        prof2, stats2 = poker.profile(obs2, num_samples=two["draws"],
                                      num_warmup=two["warmup"], seed=two["seed"], device=dev)
        syncs2 = _last_run_syncs()
    table2 = poker.compare(truth2, prof2)
    v2 = [float(np.mean(p["vpip"])) for p in prof2]
    out["two_player"] = {"vpip_mean": dict(zip([r["player"] for r in table2], v2)),
                         "divergences": int(stats2["divergences"].sum()),
                         "host_syncs": syncs2, "wall_s": meas2.wall_s}
    out["host_syncs"] += syncs2
    out["wall_s"] += meas2.wall_s
    if not v2[0] < v2[1]:
        fails.append(f"two-player: nit vpip {v2[0]:.3f} not below maniac's {v2[1]:.3f}")
    if table2[0]["player"] != "nit":
        fails.append(f"two-player: first row {table2[0]['player']!r}")
    if not _finite(prof2):
        fails.append("two-player: non-finite draws")
    return _result("apps:poker", out, fails)


def batched_vs_tables(tables, dev, n=8, seed=0):
    """The batched model's log-density against the sum of the per-table
    ``build`` models' at ``n`` seeded unconstrained points, on ``dev``:
    the largest error relative to the largest magnitude."""
    batched = compile_logp(opponent_model.build_batched(tables), ncp=False, device=dev)
    t, p = len(tables), max(len(obs) for obs in tables)
    rng = np.random.default_rng(seed)
    z = {e.id: rng.normal(size=(n,) + e.ushape).astype(np.float32)
         for e in batched.pm.entries}
    want = torch.zeros(n, dtype=torch.float64)
    for ti, obs in enumerate(tables):
        single = compile_logp(opponent_model.build(obs), ncp=False, device=dev)
        zt = {e.id: (z[e.id][:, ti, :len(obs)] if e.id.endswith("_raw") else z[e.id][:, ti])
              for e in single.pm.entries}
        want += single.logp(single.pm.pack(zt).to(dev)).double().cpu()
    got = batched.logp(batched.pm.pack(z).to(dev)).double().cpu()
    return {"T": t, "P": p, "rel_err": float((got - want).abs().max() / want.abs().max())}


def check_poker_multitable(device="cuda", mt=MULTITABLE):
    """The multi-table session: one batched NUTS run over every table."""
    dev = prepare_device(device)
    session = poker.MultiTable(num_tables=mt["tables"], seed=mt["seed"]).play(hands=mt["hands"])
    tables = [t.observations for t in session.tables]
    four = poker.MultiTable(num_tables=4, seed=mt["seed"] + 1).play(hands=mt["hands"])
    sums = [batched_vs_tables(tables, dev),
            batched_vs_tables([t.observations for t in four.tables], dev)]
    with _Measure(dev) as meas:
        profiles, stats = session.profile_all(num_warmup=mt["warmup"],
                                              num_samples=mt["draws"],
                                              seed=mt["nuts_seed"], device=dev)
        syncs = _last_run_syncs()
    vpip = [[float(np.mean(p["vpip"])) for p in tp] for tp in profiles]
    out = {"tables": mt["tables"], "hands": mt["hands"], "iters": [mt["warmup"], mt["draws"]],
           "vpip_mean": vpip, "batched_vs_tables": sums,
           "divergences": int(stats["divergences"].sum()),
           "depth_mean": float(stats["depth"].mean()),
           "leapfrog_per_iter": float(stats["n_steps"].mean()),
           "host_syncs": syncs, "wall_s": meas.wall_s, "peak_mb": meas.peak_mb}
    fails = [f"batched log-density at T = {s['T']}, P = {s['P']} off the tables' sum "
             f"by {s['rel_err']:.3g}" for s in sums if not s["rel_err"] <= REL_VALUE]
    if len(profiles) != mt["tables"] or any(len(tp) != 3 for tp in profiles):
        fails.append(f"profiles {[len(tp) for tp in profiles]}")
    if not all(_finite(tp) for tp in profiles):
        fails.append("non-finite draws")
    for ti, v in enumerate(vpip):
        if not v[1] > v[2]:
            fails.append(f"table {ti}: lag vpip {v[1]:.3f} not above nit's {v[2]:.3f}")
    return _result("apps:poker_multitable", out, fails)


def example05_forward(iterations, sensors="bottom_row"):
    """Example 05's forward map of one (ny, nx) field, read at
    ``sensors`` (as ``read_sensors`` takes them; the example's own are
    the bottom row)."""
    def forward(phi):
        kappa = physics.material_field(phi, 2.0, 0.5)
        t = physics.heat2d_solve(kappa, iterations=iterations)
        return physics.read_sensors(t, sensors)

    return forward


def interior_sensors(ny, nx):
    """The row above the bottom boundary, as (row, col) positions:
    interior cells, which the Jacobi steps update."""
    return [(ny - 2, c) for c in range(nx)]


def example05_data(ny, nx, iterations, sensors="bottom_row"):
    """Example 05's truth and noisy sensor data (float32 numpy): a void
    (phi < 0) in the upper-left block, the forward map on the CPU, and
    noise N(0, 0.01) from ``default_rng(0)``."""
    phi_true = np.ones((ny, nx), np.float32)
    phi_true[1:ny // 2, 1:nx // 2] = -1.0
    data = example05_forward(iterations, sensors)(torch.as_tensor(phi_true)).numpy()
    noisy = data + np.random.default_rng(0).normal(0, 0.01, data.shape).astype(np.float32)
    return phi_true, noisy


def physics_ir(cfg=PHYSICS, sensors="bottom_row"):
    phi_true, noisy = example05_data(cfg["ny"], cfg["nx"], cfg["iterations"], sensors)
    ir = physics.build_inverse_model(example05_forward(cfg["iterations"], sensors), noisy,
                                     ny=cfg["ny"], nx=cfg["nx"],
                                     noise_sigma=cfg["noise_sigma"], lam=cfg["lam"])
    return ir, phi_true


def physics_summary(trace, stats, phi_true, max_depth):
    """What the physics gates read, from a trace and its stats (numpy;
    the JAX package's runs give the same keys)."""
    ny, nx = phi_true.shape
    phi_post = np.asarray(trace["phi"]).mean(axis=(0, 1)).reshape(ny, nx)
    return {"max_depth_share": float((np.asarray(stats["depth"]) == max_depth).mean()),
            "step_size": float(np.mean(stats["step_size"])),
            "inferred_void": float((phi_post < 0).mean()),
            "true_void": float((phi_true < 0).mean()),
            "divergences": int(np.asarray(stats["diverging"]).sum())}


def check_physics(device="cuda", cfg=PHYSICS):
    """Example 05 at full width, at a cut depth."""
    from exmc_tpu_torch import sample

    dev = prepare_device(device)
    ir, phi_true = physics_ir(cfg)
    err = compile_check(ir, dev, ncp=True)
    ir_interior, _ = physics_ir(cfg, interior_sensors(cfg["ny"], cfg["nx"]))
    err_interior = compile_check(ir_interior, dev, ncp=True, n_points=cfg["chains"])
    with _Measure(dev) as meas:
        trace, stats = sample(ir, num_chains=cfg["chains"], num_warmup=cfg["warmup"],
                              num_samples=cfg["draws"], seed=cfg["seed"],
                              max_tree_depth=cfg["max_tree_depth"], device=dev)
        syncs = _last_run_syncs()
    summ = physics_summary(trace, stats, phi_true, cfg["max_tree_depth"])
    out = {"grid": [cfg["ny"], cfg["nx"]], "jacobi_iterations": cfg["iterations"],
           "chains": cfg["chains"], "iters": [cfg["warmup"], cfg["draws"]],
           "reduced": PHYSICS_REDUCED, **summ, "physics_jax": PHYSICS_JAX,
           "compile_check": err, "compile_check_interior": err_interior,
           "host_syncs": syncs, "wall_s": meas.wall_s,
           "peak_mb": meas.peak_mb}
    fails = (_compile_fails("example 05 model", err)
             + _compile_fails("interior-sensor model", err_interior))
    if not np.isfinite(trace["phi"]).all():
        fails.append("non-finite draws")
    if PHYSICS_JAX is not None:
        lo, hi = PHYSICS_JAX["max_depth_share"]
        if not lo - DEPTH_SHARE_TOL <= summ["max_depth_share"] <= hi + DEPTH_SHARE_TOL:
            fails.append(f"max-depth share {summ['max_depth_share']:.3f} outside JAX's "
                         f"[{lo:.3f}, {hi:.3f}] +- {DEPTH_SHARE_TOL}")
        lo, hi = PHYSICS_JAX["step_size"]
        if not lo / STEP_SIZE_FACTOR <= summ["step_size"] <= hi * STEP_SIZE_FACTOR:
            fails.append(f"step size {summ['step_size']:.3g} outside JAX's "
                         f"[{lo:.3g}, {hi:.3g}] widened {STEP_SIZE_FACTOR}x")
    return _result("apps:physics", out, fails)


def _leapfrog_chain(q0, p0, eps, n, inv_mass):
    """An n-step float64 leapfrog chain on the standard Gaussian."""
    qs, ps, lps = [], [], []
    q, p = q0.copy(), p0.copy()
    g = -q
    for _ in range(n):
        p_half = p + 0.5 * eps * g
        q = q + eps * inv_mass * p_half
        g = -q
        p = p_half + 0.5 * eps * g
        qs.append(q.copy())
        ps.append(p.copy())
        lps.append(-0.5 * float(q @ q))
    return np.array(qs), np.array(ps), np.array(lps)


def _iso_vag(q):
    return -0.5 * torch.sum(q * q, dim=-1), -q


def check_native_lockstep(device="cuda", n_trials=300, d=2, eps=0.45, max_depth=6, seed=0):
    """The port's native tree (g++) against the device's masked tree on
    forced directions: seeded momenta, direction bits and log-uniforms
    are injected into ``nuts_transition`` on the device, and the same
    directions are forced into ``native.build_full_tree`` on float64
    leapfrog chains from the same start."""
    dev = prepare_device(device)
    t0 = time.perf_counter()
    avail = native.available()
    out = {"trees": n_trials, "native_available": avail,
           "native_build_s": native.build_seconds,
           "native_library": str(native.library_path())}
    if not avail:
        return _result(NATIVE_TASK, out, ["native tree unavailable (g++ build failed)"])
    rng = np.random.default_rng(seed)
    q0 = np.array([0.7, -0.4])
    z = rng.normal(size=(n_trials, d)).astype(np.float32)
    dirs = rng.random((n_trials, max_depth)) < 0.5
    merges = -rng.exponential(size=(n_trials, max_depth)).astype(np.float32)
    leaves = -rng.exponential(
        size=(n_trials, max_depth, 2 ** (max_depth - 1))).astype(np.float32)
    q = torch.as_tensor(np.tile(q0, (n_trials, 1)), dtype=torch.float32, device=dev)
    logp, grad = _iso_vag(q)
    rand = {k: torch.as_tensor(v, device=dev) for k, v in
            (("r0_z", z), ("go_right", dirs), ("merge_logu", merges), ("leaf_logu", leaves))}
    _, _, _, stats = nuts_transition(
        _iso_vag, make_metric(torch.ones(n_trials, d, device=dev)),
        torch.full((n_trials,), eps, device=dev), q, logp, grad, max_depth, rand=rand)
    stats = {k: v.cpu().numpy() for k, v in stats.items()}
    mismatched, acc_err, depths = [], 0.0, set()
    for t in range(n_trials):
        r0 = z[t].astype(np.float64)
        fwd = _leapfrog_chain(q0, r0, eps, 2 ** max_depth, np.ones(d))
        bwd = _leapfrog_chain(q0, r0, -eps, 2 ** max_depth, np.ones(d))
        res = native.build_full_tree(q0, r0, -0.5 * float(q0 @ q0), fwd, bwd, np.ones(d),
                                     max_depth=max_depth, seed=t,
                                     dirs=[1 if b else -1 for b in dirs[t]])
        if not (res["ok"] and res["depth"] == stats["depth"][t]
                and res["n_leapfrog"] == stats["n_steps"][t]
                and res["diverging"] == bool(stats["diverging"][t])):
            mismatched.append(t)
        acc_err = max(acc_err, abs(res["accept_prob"] - float(stats["accept_prob"][t])))
        depths.add(res["depth"])
    out.update({"shape_mismatches": len(mismatched), "accept_max_abs_err": acc_err,
                "depths_seen": sorted(depths), "wall_s": time.perf_counter() - t0})
    fails = []
    if mismatched:
        fails.append(f"tree shape differs on {len(mismatched)} trees (first {mismatched[:5]})")
    if not acc_err < 5e-4:
        fails.append(f"accept statistic off by {acc_err:.3g}")
    if len(depths) < 3:
        fails.append(f"only depths {sorted(depths)} reached")
    return _result(NATIVE_TASK, out, fails)


# The cold-start probe, run in a fresh interpreter: it imports the port,
# builds the CUDA sources (0 s when cached on disk), then runs eight
# schools twice in the same process, counting CUDA graph captures.
_COLD_START = r"""
import json, sys, time
t0 = time.perf_counter()
import numpy as np
import torch
import exmc_tpu_torch
from exmc_tpu_torch import _build, bench, compiler
from exmc_tpu_torch.nuts.sampler import _make_sampler
import_s = time.perf_counter() - t0
device, chains, warmup, draws = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
captures = [0]
capture = compiler.GraphedValueAndGrad._capture
def counted(self, *a):
    captures[0] += 1
    return capture(self, *a)
compiler.GraphedValueAndGrad._capture = counted
built = _build.build_all() if device == "cuda" else {}
runs = []
for _ in range(2):
    before = captures[0]
    t0 = time.perf_counter()
    sampler = _make_sampler(bench.eight_schools_ir(), device=device, num_warmup=warmup,
                            num_samples=draws, pooled_adaptation=True)
    trace, _ = sampler.run(num_chains=chains, seed=0, init=("superchain", 32))
    if device == "cuda":
        torch.cuda.synchronize()
    runs.append({"wall_s": time.perf_counter() - t0, "graph_captures": captures[0] - before,
                 "host_syncs": sampler.last_run["host_syncs"],
                 "finite": all(bool(np.isfinite(v).all()) for v in trace.values())})
print(json.dumps({"import_s": import_s, "nvcc_build_s": sum(b["seconds"] for b in built.values()),
                  "runs": runs}))
"""


def check_cold_start(device="cuda", chains=1024, warmup=20, draws=20, timeout_s=600):
    """A fresh process: import, build, then eight schools twice."""
    dev = prepare_device(device)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _COLD_START, dev.type, str(chains), str(warmup), str(draws)],
        cwd=root, capture_output=True, text=True, timeout=timeout_s)
    process_s = time.perf_counter() - t0
    if proc.returncode != 0:
        return _result("aot:cold_start", {"process_s": process_s},
                       [f"probe failed: {proc.stderr[-2000:]}"])
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    first, second = res["runs"]
    out = {"chains": chains, "iters": [warmup, draws], **res, "process_s": process_s,
           "first_run_excess_s": first["wall_s"] - second["wall_s"]}
    fails = []
    if not (first["finite"] and second["finite"]):
        fails.append("non-finite draws")
    if dev.type == "cuda" and not (first["graph_captures"] >= 1
                                   and second["graph_captures"] == 0):
        fails.append(f"graph captures {first['graph_captures']}, {second['graph_captures']} "
                     "(expected some in the first run, none in the second)")
    return _result("aot:cold_start", out, fails)


CHECKS = {"apps:poker": check_poker, "apps:poker_multitable": check_poker_multitable,
          "apps:physics": check_physics, "aot:cold_start": check_cold_start,
          NATIVE_TASK: check_native_lockstep}


def run_task(task, device="cuda"):
    """One task: a list of result dicts with their phase."""
    return [dict(phase="apps", **CHECKS[task](device))]


def main(argv=None):
    ap = argparse.ArgumentParser(description="Drive the port's application layer.")
    ap.add_argument("--task", action="append", choices=[NATIVE_TASK] + TASKS,
                    help="a task to run (repeatable; default: all)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ok = True
    for task in args.task or [NATIVE_TASK] + TASKS:
        for res in run_task(task, args.device):
            ok = ok and res["ok"]
            print(json.dumps(res), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
