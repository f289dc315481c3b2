"""The model families driven on one device: the ``families`` tasks of
``chip_smoke.py``, at the examples' full (non-smoke) widths and data.
The NUTS runs of examples 41, 42, 45 and 47 and of the GLM fits are cut
to half their iterations (listed below; their gates unchanged) to keep
``chip_smoke.py`` under its time target (PERF.md, Findings). Each
check returns one dict with ``ok``, the list of ``failures`` and what it
measured (wall seconds, host syncs where a loop reads the device, peak
device memory); the tests run the same code on the CPU at small sizes.

* ``families:inla_t5000`` (``check_inla``): ``sv_inla`` on
  ``suite.sv_model(t=5000)``'s returns, the default 40 x 40 grid,
  ``newton_iters=25``, in float64, the whole grid as one batch. Gate:
  the sigma and nu means within 0.5 of their INLA sd of LONGT.json's
  ``sv_inla_marginal`` T = 5000 row (0.02334 +- 0.00272; 10.5 +- 1.5).
* ``families:smoothness`` (``check_smoothness``): DESIGN D-T39's
  transect (``scripts/probe_marginal_smoothness.py``): logZ at 192 sigma
  points +-1 sd around the T = 5000 mode (nu = 10.872, 12 Newton
  iterations), in f32 and f64, summarized by the std of third
  differences. Gate: f64 below 1e-6 (the JAX package's CPU run: f32
  0.156, f64 7.6e-8). It also times the compiled SV-marginal model's
  value-and-grad (4 chains, replayed from its CUDA graph on the card)
  at T = 2000 and 5000 in f32 and f64.
* ``families:sv_marginal`` (``check_sv_marginal``): example 45 at
  T = 2000: INLA (``newton_iters=15, grid_batch=64``), then NUTS on
  ``sv_marginal_model`` (4 chains, 200 + 150: the example's 500 + 1000
  cut by half, then to 250 + 250 and 200 + 150 to keep
  ``chip_smoke.py`` within its budget beside the parallel phase;
  float64). Gates: the example's z-scores of the NUTS
  means against INLA < 3, R-hat < 1.05.
* ``families:ar_kalman`` (``check_ar_kalman``): example 47 at T = 400
  (NUTS on the AR(1) marginal, 4 chains, 250 + 250, cut from 500 + 500;
  the Kalman smoother's bands at the posterior mean). Gates: the
  example's.
* ``families:hmm`` (``check_hmm``): example 42 at T = 400 (2 chains,
  200 + 250, cut from 400 + 500; smoothing and Viterbi at the posterior
  mean). Gates: the example's recovery and decoding asserts.
* ``families:gp_glm`` (``check_gp_glm``): example 41 (N = 50, 2 chains,
  250 + 250, cut from 500 + 500: the marginal GP regression, which runs
  eagerly (a sampled covariance), and ``gp_predict``, the latent
  classifier) and ``tests/test_glm.py``'s four GLM fits at its sizes
  (2 chains, 200 + 200, cut from 400 + 400), each with its gates.
* ``families:particle`` (``check_particle``): example 13 (the SIR
  epidemic: a 512-particle filter, PMMH with 4 chains x 800) and
  ``smc2`` at ``tests/test_particle.py``'s sizes against the Kalman
  quadrature. Gates: the example's and the test's.
* ``tree:invariance`` (``check_invariance``): the exact-invariance
  battery of ``tests/test_exact_invariance.py`` (8192 chains, R = 4
  replicates of K = 8 transitions, Holm alpha 0.005) on the port's tree
  on the device, on the isotropic and the correlated Gaussian. Gate: no
  Holm rejection on either.

    python -m exmc_tpu_torch.benchmarks.families [--task TASK ...] [--device cpu]
"""

import argparse
import json
import math
import sys
import time

import numpy as np
import scipy.stats as st
import torch

from exmc_tpu_torch import Builder, config, dists
from exmc_tpu_torch.benchmarks.suite import sv_model
from exmc_tpu_torch.compiler import compile_logp
from exmc_tpu_torch.config import prepare_device
from exmc_tpu_torch.diagnostics import _ess as ess
from exmc_tpu_torch.diagnostics import _rhat as rhat
from exmc_tpu_torch.dsl import Model
from exmc_tpu_torch.glm import glm
from exmc_tpu_torch.gp import gp_latent, gp_marginal, gp_predict
from exmc_tpu_torch.hmm import hmm_dist, posterior_state_probs, viterbi
from exmc_tpu_torch.kalman import add_obs_noise, ar_ssm, kalman_smoother
from exmc_tpu_torch.marginal import (
    _sv_loglik,
    make_ar1_marginal,
    make_grw_marginal,
    sv_inla,
    sv_marginal_model,
)
from exmc_tpu_torch.nuts.leapfrog import make_metric
from exmc_tpu_torch.nuts.masked import HostSyncs
from exmc_tpu_torch.nuts.sampler import _make_sampler
from exmc_tpu_torch.nuts.tree import nuts_transition
from exmc_tpu_torch.particle import particle_filter, pmcmc, smc2
from exmc_tpu_torch.particle.filter import make_log_marginal_fn

TASKS = ["families:inla_t5000", "families:smoothness", "families:sv_marginal",
         "families:ar_kalman", "families:hmm", "families:gp_glm", "families:particle",
         "tree:invariance"]
# LONGT.json's sv_inla_marginal row at T = 5000 (the JAX package, CPU mesh)
INLA_T5000 = {"sigma_mean": 0.02334, "sigma_sd": 0.00272, "nu_mean": 10.5, "nu_sd": 1.5}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Measure:
    """Wall seconds (synchronized) and peak device memory of a block."""

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self):
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        _sync(self.dev)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.dev)
        self.wall_s = time.perf_counter() - self.t0
        self.peak_mb = (torch.cuda.max_memory_allocated(self.dev) / 2 ** 20
                        if self.dev.type == "cuda" else None)
        return False


def _result(check, out, fails):
    return dict(out, check=check, ok=not fails, failures=fails)


def _nuts(ir, dev, chains, warmup, draws, seed=0, **opts):
    """(trace, stats, host syncs) of a NUTS run on ``dev``."""
    sampler = _make_sampler(ir, device=dev, num_warmup=warmup, num_samples=draws, **opts)
    trace, stats = sampler.run(num_chains=chains, seed=seed)
    return trace, stats, sampler.last_run["host_syncs"]


def _sv_returns(t):
    return np.asarray(sv_model(t=t).nodes["r_obs"].op[2])


# ---------------------------------------------------------------------------
# INLA, the D-T39 transect, the SV marginal under NUTS
# ---------------------------------------------------------------------------

def check_inla(device="cuda", t=5000, newton_iters=25, grid=40, ref=INLA_T5000):
    """sv_inla at T = 5000 in float64, the whole grid in one batch."""
    dev = prepare_device(device)
    r = _sv_returns(t)
    with config.x64(), _Measure(dev) as m:
        res = sv_inla(r, sigma_grid=np.geomspace(0.002, 0.2, grid),
                      nu_grid=np.geomspace(2.0, 80.0, grid), newton_iters=newton_iters,
                      device=dev)
    out = {"T": t, "grid_points": grid * grid, "newton_iters": newton_iters,
           "dtype": "float64", "wall_s": m.wall_s, "peak_mb": m.peak_mb, "host_syncs": 1,
           "n_failed": res["n_failed"], "reference": ref}
    out.update({k: res[k] for k in ("sigma_mean", "sigma_sd", "nu_mean", "nu_sd")})
    fails = []
    if ref is not None:
        for k in ("sigma", "nu"):
            z = abs(res[f"{k}_mean"] - ref[f"{k}_mean"]) / ref[f"{k}_sd"]
            out[f"z_{k}"] = z
            if not z < 0.5:
                fails.append(f"{k} mean {res[f'{k}_mean']:.5g} is {z:.2f} INLA sd from "
                             f"LONGT.json's {ref[f'{k}_mean']}")
    return _result("families:inla_t5000", out, fails)


def _vag_ms(t, dev, reps, newton_iters=15, chains=4):
    """ms of the compiled SV-marginal model's value-and-grad (4 chains;
    replayed from its CUDA graph on the card)."""
    model = compile_logp(sv_marginal_model(_sv_returns(t), newton_iters=newton_iters),
                         ncp=False, device=dev)
    x = torch.tensor([[math.log(0.03), math.log(10.0)]] * chains,
                     dtype=config.default_dtype(), device=dev)
    for _ in range(3):
        model.value_and_grad(x)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        model.value_and_grad(x)
    _sync(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def check_smoothness(device="cuda", t=5000, points=192, newton_iters=12,
                     timing_t=(2000, 5000), timing_reps=20):
    """D-T39's transect in f32 and f64, and the value-and-grad times."""
    dev = prepare_device(device)
    t0 = time.perf_counter()
    r = _sv_returns(t)
    sig = np.linspace(0.0233 - 0.0026, 0.0233 + 0.0026, points)
    out, fails = {"T": t, "points": points, "newton_iters": newton_iters}, []
    for x64 in (False, True):
        name = "f64" if x64 else "f32"
        with config.x64(x64), torch.no_grad(), _Measure(dev) as m:
            marg = make_grw_marginal(_sv_loglik(r), t, newton_iters=newton_iters)
            s = torch.as_tensor(sig, dtype=config.default_dtype(), device=dev)
            lz = marg(s, {"nu": torch.full_like(s, 10.872)})[0].double().cpu().numpy()
        out[f"d3_std_{name}"] = float(np.std(np.diff(lz, 3)))
        out[f"wall_s_{name}"] = m.wall_s
        out[f"finite_{name}"] = bool(np.isfinite(lz).all())
        for tt in timing_t:
            with config.x64(x64):
                out[f"vag_ms_T{tt}_{name}"] = _vag_ms(tt, dev, timing_reps)
    out["jax_cpu_reference"] = {"d3_std_f32": 0.156, "d3_std_f64": 7.6e-8}
    out["wall_s"] = time.perf_counter() - t0
    if not (out["finite_f64"] and out["d3_std_f64"] < 1e-6):
        fails.append(f"f64 transect third-difference std {out['d3_std_f64']:.3g} >= 1e-6")
    return _result("families:smoothness", out, fails)


def check_sv_marginal(device="cuda", t=2000, iters=(200, 150), chains=4, newton_iters=15,
                      grid_batch=64):
    """Example 45 at T = 2000: INLA, then NUTS on the marginal in f64."""
    dev = prepare_device(device)
    r = _sv_returns(t)
    out, fails = {"T": t, "chains": chains, "iters": list(iters), "dtype": "float64"}, []
    with config.x64():
        with _Measure(dev) as m:
            inla = sv_inla(r, newton_iters=newton_iters, grid_batch=grid_batch, device=dev)
        out["inla"] = {k: inla[k] for k in ("sigma_mean", "sigma_sd", "nu_mean", "nu_sd",
                                            "n_failed")}
        out["inla_wall_s"], out["inla_peak_mb"] = m.wall_s, m.peak_mb
        with _Measure(dev) as m:
            trace, stats, syncs = _nuts(sv_marginal_model(r, newton_iters=newton_iters), dev,
                                        chains, *iters, ncp=False)
    out["nuts_wall_s"], out["nuts_peak_mb"], out["host_syncs"] = m.wall_s, m.peak_mb, syncs
    out["wall_s"] = out["inla_wall_s"] + out["nuts_wall_s"]
    sig, nu = trace["sigma"], trace["nu"]
    out.update(sigma_mean=float(sig.mean()), nu_mean=float(nu.mean()),
               rhat_sigma=float(rhat(sig)), rhat_nu=float(rhat(nu)),
               min_ess=min(float(ess(sig)), float(ess(nu))),
               divergences=int(stats["divergences"].sum()),
               mean_depth=float(stats["depth"].mean()),
               step_size_dtype=str(stats["step_size"].dtype))
    out["z_sigma"] = abs(out["sigma_mean"] - inla["sigma_mean"]) / inla["sigma_sd"]
    out["z_nu"] = abs(out["nu_mean"] - inla["nu_mean"]) / inla["nu_sd"]
    if not (out["z_sigma"] < 3.0 and out["z_nu"] < 3.0):
        fails.append(f"NUTS vs INLA z-scores {out['z_sigma']:.2f}, {out['z_nu']:.2f}")
    if not max(out["rhat_sigma"], out["rhat_nu"]) < 1.05:
        fails.append(f"R-hat {out['rhat_sigma']:.4f} / {out['rhat_nu']:.4f}")
    return _result("families:sv_marginal", out, fails)


def check_ar_kalman(device="cuda", t=400, iters=(250, 250), chains=4):
    """Example 47: NUTS on the AR(1) marginal, then Kalman bands."""
    dev = prepare_device(device)
    rng = np.random.default_rng(0)
    phi_true, sig_true, r_sd = 0.9, 0.35, 0.5
    s = np.zeros(t)
    s[0] = rng.normal(0, sig_true / np.sqrt(1 - phi_true ** 2))
    for i in range(1, t):
        s[i] = phi_true * s[i - 1] + rng.normal(0, sig_true)
    ys = s + rng.normal(0, r_sd, t)
    yj = torch.as_tensor(ys, dtype=torch.float32, device=dev)

    def loglik(path, theta):
        return -0.5 * ((yj - path) / r_sd) ** 2

    marginal = make_ar1_marginal(loglik, t, newton_iters=8)

    def lp(_value, params):
        return marginal(params["sigma"], params["phi"], {})[0]

    ir = Builder.rv(Builder.new_ir(), "sigma", dists.HalfNormal, {"sigma": 1.0})
    ir = Builder.rv(ir, "phi", dists.Uniform, {"lower": -0.99, "upper": 0.99})
    ir = Builder.rv(ir, "lik", dists.Custom(logpdf_fn=lp, support="real"),
                    {"sigma": "sigma", "phi": "phi"})
    ir = Builder.obs(ir, "lik_obs", "lik", 0.0)
    with _Measure(dev) as m:
        trace, stats, syncs = _nuts(ir, dev, chains, *iters, ncp=False)
        phi_mean, sig_mean = float(trace["phi"].mean()), float(trace["sigma"].mean())
        mu_s, P_s = kalman_smoother(add_obs_noise(
            ar_ssm(np.array([phi_mean]), sig_mean, device=dev), r_sd ** 2), ys)
    band = np.sqrt(P_s[:, 0, 0].cpu().numpy())
    inside = float((np.abs(mu_s[:, 0].cpu().numpy() - s) < 2.5 * band).mean())
    out = {"T": t, "chains": chains, "iters": list(iters), "phi_mean": phi_mean,
           "sigma_mean": sig_mean, "divergences": int(stats["divergences"].sum()),
           "inside_band": inside, "host_syncs": syncs, "wall_s": m.wall_s,
           "peak_mb": m.peak_mb}
    fails = []
    if not abs(phi_mean - phi_true) < 0.15:
        fails.append(f"phi mean {phi_mean:.3f}")
    if out["divergences"]:
        fails.append(f"{out['divergences']} divergences")
    if not inside > 0.9:
        fails.append(f"latent path inside the 2.5-sd band {inside:.2f}")
    return _result("families:ar_kalman", out, fails)


# ---------------------------------------------------------------------------
# HMM, GP and GLM
# ---------------------------------------------------------------------------

def _hmm_emission(yv, k, params):
    z = (yv - params["mus"][k]) / params["sigma"]
    return -0.5 * z * z - torch.log(params["sigma"]) - 0.5 * math.log(2 * math.pi)


def check_hmm(device="cuda", t=400, iters=(200, 250), chains=2):
    """Example 42: a regime-switching Gaussian HMM, then decoding."""
    dev = prepare_device(device)
    rng = np.random.default_rng(0)
    trans, mus, sigma = np.array([[0.92, 0.08], [0.15, 0.85]]), np.array([-0.8, 1.6]), 0.6
    s = np.zeros(t, int)
    for i in range(1, t):
        s[i] = rng.choice(2, p=trans[s[i - 1]])
    y = (mus[s] + sigma * rng.normal(size=t)).astype(np.float32)
    with Model() as m:
        m.rv("mus", dists.Normal, {"mu": 0.0, "sigma": 3.0}, transform="ordered", shape=(2,))
        m.rv("sigma", dists.HalfNormal, {"sigma": 2.0})
        m.rv("p00", dists.Beta, {"alpha": 2.0, "beta": 2.0})
        m.rv("p11", dists.Beta, {"alpha": 2.0, "beta": 2.0})
        m.det("trans", lambda a, b: torch.stack([torch.stack([a, 1 - a]),
                                                 torch.stack([1 - b, b])]), ["p00", "p11"])
        m.rv("y", hmm_dist(_hmm_emission, 2, stationary_init=True),
             {"trans": "trans", "mus": "mus", "sigma": "sigma"})
        m.obs("y_obs", "y", y)
    with _Measure(dev) as meas:
        trace, stats, syncs = _nuts(m.ir, dev, chains, *iters)
        mus_post = trace["mus"].reshape(-1, 2).mean(axis=0)
        p00, p11 = float(trace["p00"].mean()), float(trace["p11"].mean())
        params = {"mus": mus_post, "sigma": float(trace["sigma"].mean()),
                  "trans": np.array([[p00, 1 - p00], [1 - p11, p11]])}
        gamma = posterior_state_probs(_hmm_emission, y, params, 2, stationary_init=True,
                                      device=dev).cpu().numpy()
        path = viterbi(_hmm_emission, y, params, 2, stationary_init=True,
                       device=dev).cpu().numpy()
    out = {"T": t, "chains": chains, "iters": list(iters), "mus_mean": mus_post.tolist(),
           "sigma_mean": params["sigma"], "p00_mean": p00, "p11_mean": p11,
           "divergences": int(stats["divergences"].sum()),
           "rhat_mus0": float(rhat(trace["mus"][:, :, 0])),
           "smoothing_accuracy": float(((gamma[:, 1] > 0.5).astype(int) == s).mean()),
           "viterbi_accuracy": float((path == s).mean()), "host_syncs": syncs,
           "wall_s": meas.wall_s, "peak_mb": meas.peak_mb}
    fails = []
    if not np.abs(mus_post - mus).max() < 0.3:
        fails.append(f"state means {mus_post.round(3).tolist()}")
    if not out["viterbi_accuracy"] > 0.85:
        fails.append(f"Viterbi accuracy {out['viterbi_accuracy']:.2f}")
    return _result("families:hmm", out, fails)


def _gp_example(dev, n, iters, chains):
    """Example 41: GP regression (marginal) and classification (latent)."""
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(-3, 3, n))
    y = np.sin(2 * X) + 0.2 * rng.normal(size=n)
    with Model() as m:
        m.rv("ls", dists.HalfNormal, {"sigma": 2.0})
        m.rv("amp", dists.HalfNormal, {"sigma": 2.0})
        m.rv("sn", dists.HalfNormal, {"sigma": 1.0})
        gp_marginal(m, "y", X, y, kernel="rbf", lengthscale="ls", variance="amp", noise="sn")
    out, fails = {}, []
    with _Measure(dev) as meas:
        trace, stats, syncs = _nuts(m.ir, dev, chains, *iters)
    Xs = np.linspace(-3, 3, 60)
    fs = gp_predict(trace, X, Xs, kernel="rbf", lengthscale="ls", variance="amp",
                    noise="sn", y=y, num_draws=200, device=dev)
    err = float(np.abs(fs.mean(0) - np.sin(2 * Xs)).mean())
    out["regression"] = {"sn_mean": float(trace["sn"].mean()), "prediction_error": err,
                         "divergences": int(stats["divergences"].sum()),
                         "rhat_ls": float(rhat(trace["ls"])), "host_syncs": syncs,
                         "wall_s": meas.wall_s}
    p_true = 1 / (1 + np.exp(-3 * np.sin(2 * X)))
    yb = (rng.uniform(size=n) < p_true).astype(np.int32)
    with Model() as mc:
        mc.rv("ls", dists.HalfNormal, {"sigma": 2.0})
        mc.rv("amp", dists.HalfNormal, {"sigma": 3.0})
        gp_latent(mc, "f", X, kernel="rbf", lengthscale="ls", variance="amp")
        mc.rv("yb", dists.Bernoulli, {"logits": "f"}, shape=(n,))
        mc.obs("yb_obs", "yb", yb)
    with _Measure(dev) as meas:
        trc, stc, syncs = _nuts(mc.ir, dev, chains, *iters, seed=1, target_accept=0.9)
    fs = gp_predict(trc, X, Xs, kernel="rbf", lengthscale="ls", variance="amp",
                    f_name="f", jitter=1e-4, num_draws=200, device=dev)
    agree = float((((1 / (1 + np.exp(-fs))).mean(0) > 0.5) == (np.sin(2 * Xs) > 0)).mean())
    out["classification"] = {"agreement": agree, "divergences": int(stc["divergences"].sum()),
                             "host_syncs": syncs, "wall_s": meas.wall_s}
    if not err < 0.25:
        fails.append(f"GP regression prediction error {err:.3f}")
    if not agree > 0.85:
        fails.append(f"GP classification agreement {agree:.2f}")
    return out, fails


def _glm_fits(dev, iters, chains):
    """``tests/test_glm.py``'s four fits at its sizes and gates."""
    beta = np.array([1.5, -0.8])

    def design(n=200, seed=0):
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(n, 2))
        return rng, X, X @ beta + 0.5

    def fit(family, y, X):
        with Model() as m:
            glm(m, X, y, family=family)
        trace, stats, _ = _nuts(m.ir, dev, chains, *iters)
        return trace, stats

    def coef(trace):
        return trace["beta"].reshape(-1, 2).mean(axis=0)

    out, fails = {}, []
    rng, X, eta = design()
    y = eta + 0.4 * rng.normal(size=len(eta))
    tr, stats = fit("normal", y, X)
    out["normal"] = {"beta": coef(tr).tolist(), "beta_0": float(tr["beta_0"].mean()),
                     "sigma": float(tr["y_sigma"].mean()),
                     "divergences": int(stats["divergences"].sum())}
    if not (np.abs(coef(tr) - beta).max() < 0.12 and abs(out["normal"]["beta_0"] - 0.5) < 0.12
            and abs(out["normal"]["sigma"] - 0.4) < 0.08 and not out["normal"]["divergences"]):
        fails.append(f"glm normal {out['normal']}")

    rng, X, eta = design()
    y = eta + 0.4 * rng.normal(size=len(eta))
    y[:8] += 25.0
    tr_r, _ = fit("robust", y, X)
    tr_n, _ = fit("normal", y, X)
    out["robust"] = {"beta": coef(tr_r).tolist(), "sigma": float(tr_r["y_sigma"].mean()),
                     "normal_sigma": float(tr_n["y_sigma"].mean())}
    if not (np.abs(coef(tr_r) - beta).max() < 0.15
            and out["robust"]["sigma"] < out["robust"]["normal_sigma"] / 2):
        fails.append(f"glm robust {out['robust']}")

    rng, X, eta = design(n=400)
    y = (rng.uniform(size=len(eta)) < 1 / (1 + np.exp(-eta))).astype(float)
    tr, stats = fit("logistic", y, X)
    out["logistic"] = {"beta": coef(tr).tolist(), "divergences": int(stats["divergences"].sum())}
    if not (np.abs(coef(tr) - beta).max() < 0.45 and not out["logistic"]["divergences"]):
        fails.append(f"glm logistic {out['logistic']}")

    rng, X, _ = design(n=300, seed=1)
    eta = X @ np.array([0.6, -0.3]) + 1.0
    tr, stats = fit("poisson", rng.poisson(np.exp(eta)).astype(float), X)
    tr2, _ = fit("negbin", rng.poisson(np.exp(eta) * rng.gamma(2.0, 0.5, size=len(eta)))
                 .astype(float), X)
    want = np.array([0.6, -0.3])
    out["poisson_negbin"] = {"poisson_beta": coef(tr).tolist(),
                             "poisson_divergences": int(stats["divergences"].sum()),
                             "negbin_beta": coef(tr2).tolist(),
                             "negbin_alpha": float(tr2["y_alpha"].mean())}
    if not (np.abs(coef(tr) - want).max() < 0.12 and not out["poisson_negbin"]["poisson_divergences"]
            and np.abs(coef(tr2) - want).max() < 0.2
            and abs(out["poisson_negbin"]["negbin_alpha"] - 2.0) < 1.2):
        fails.append(f"glm poisson/negbin {out['poisson_negbin']}")
    return out, fails


def check_gp_glm(device="cuda", n=50, gp_iters=(250, 250), glm_iters=(200, 200), chains=2):
    dev = prepare_device(device)
    with _Measure(dev) as m:
        gp_out, gp_fails = _gp_example(dev, n, gp_iters, chains)
        glm_out, glm_fails = _glm_fits(dev, glm_iters, chains)
    out = {"gp": gp_out, "glm": glm_out, "wall_s": m.wall_s, "peak_mb": m.peak_mb}
    return _result("families:gp_glm", out, gp_fails + glm_fails)


# ---------------------------------------------------------------------------
# particle filters
# ---------------------------------------------------------------------------

SIR = {"N_POP": 10_000.0, "T": 40, "TRUE_BETA": 0.45, "GAMMA": 0.2, "RHO": 0.4}


def _sir_data(seed=17):
    rng = np.random.default_rng(seed)
    s, i = SIR["N_POP"] - 20.0, 20.0
    cases = []
    for _ in range(SIR["T"]):
        new_inf = rng.binomial(int(s), 1.0 - np.exp(-SIR["TRUE_BETA"] * i / SIR["N_POP"]))
        new_rec = rng.binomial(int(i), 1.0 - np.exp(-SIR["GAMMA"]))
        s -= new_inf
        i += new_inf - new_rec
        cases.append(rng.poisson(SIR["RHO"] * max(new_inf, 1e-9)))
    return np.asarray(cases, np.float32)


def _sir_fns():
    """Example 13's stochastic SIR model: state (s, i, new infections)
    per particle, normal approximations to the binomial steps."""
    n_pop, gamma, rho = SIR["N_POP"], SIR["GAMMA"], SIR["RHO"]

    def init_fn(gen, n, params):
        x = torch.tensor([n_pop - 20.0, 20.0, 0.0], dtype=config.default_dtype(),
                         device=gen.device)
        return x.repeat(n, 1)

    def step_fn(gen, x, t, params):
        s, i = x[:, 0], x[:, 1]
        mean_inf = s * (1.0 - torch.exp(-params["beta"] * i / n_pop))
        new_inf = torch.minimum(torch.clamp_min(
            mean_inf + torch.sqrt(torch.clamp_min(mean_inf, 1e-6))
            * torch.randn(s.shape, generator=gen, dtype=x.dtype, device=x.device), 0.0), s)
        mean_rec = i * (1.0 - math.exp(-gamma))
        new_rec = torch.minimum(torch.clamp_min(
            mean_rec + torch.sqrt(torch.clamp_min(mean_rec, 1e-6))
            * torch.randn(i.shape, generator=gen, dtype=x.dtype, device=x.device), 0.0), i)
        return torch.stack([s - new_inf, i + new_inf - new_rec, new_inf], dim=1)

    def loglik_fn(x, y, t, params):
        lam = torch.clamp_min(rho * x[:, 2], 1e-3)
        return y * torch.log(lam) - lam - torch.lgamma(y + 1.0)

    return init_fn, step_fn, loglik_fn


def _kalman_rw(ys, q, r):
    """Exact log p(y) of the random-walk-plus-noise model."""
    m, p, ll = 0.0, 0.0, 0.0
    for y in np.asarray(ys, np.float64):
        mp, pp = m, p + q * q
        s = pp + r * r
        ll += -0.5 * (np.log(2 * np.pi * s) + (y - mp) ** 2 / s)
        k = pp / s
        m, p = mp + k * (y - mp), (1 - k) * pp
    return ll


def _smc2_check(dev, n_theta, n_x, seed=0):
    """``tests/test_particle.py::test_smc2_posterior_and_evidence``."""
    q, r, t = 0.3, 0.5, 40
    rng = np.random.default_rng(0)
    ys = (np.cumsum(rng.normal(0, q, t)) + rng.normal(0, r, t)).astype(np.float32)
    grid = np.linspace(0.2, 1.2, 81)
    lls = np.array([_kalman_rw(ys, q, float(v)) for v in grid])
    w = np.exp(lls - lls.max())
    w /= np.trapezoid(w, grid)
    exact_mean = np.trapezoid(w * grid, grid)
    exact_sd = np.sqrt(np.trapezoid(w * (grid - exact_mean) ** 2, grid))
    exact_ev = np.log(np.trapezoid(np.exp(lls - lls.max()), grid) / 1.0) + lls.max()

    def init_fn(gen, n, params):
        return q * torch.randn(n, generator=gen, dtype=config.default_dtype(), device=gen.device)

    def step_fn(gen, x, t_, params):
        return x + q * torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)

    def loglik_fn(x, y, t_, params):
        rr = params[..., 0]
        z = (y - x) / rr
        return -0.5 * z * z - torch.log(rr) - 0.5 * math.log(2 * math.pi)

    def log_prior(theta):
        v = theta[..., 0]
        return torch.where((v > 0.2) & (v < 1.2), 0.0, -torch.inf)

    gen = torch.Generator(device=dev).manual_seed(seed)
    res = smc2(init_fn, step_fn, loglik_fn,
               lambda g, n: 0.2 + torch.rand(n, 1, generator=g, device=g.device),
               log_prior, ys, n_theta=n_theta, n_x=n_x, generator=gen)
    wt = torch.softmax(res["log_weights"], 0).cpu().numpy()
    th = res["thetas"][:, 0].cpu().numpy()
    post_mean = float((wt * th).sum())
    post_sd = float(np.sqrt((wt * (th - post_mean) ** 2).sum()))
    out = {"post_mean": post_mean, "post_sd": post_sd, "exact_mean": float(exact_mean),
           "exact_sd": float(exact_sd), "log_evidence": float(res["log_evidence"]),
           "exact_log_evidence": float(exact_ev), "rejuvenations": res["rejuvenations"],
           "host_syncs": res["host_syncs"]}
    fails = []
    if not abs(post_mean - exact_mean) < 3.0 * exact_sd / np.sqrt(10):
        fails.append(f"smc2 posterior mean {post_mean:.3f} vs {exact_mean:.3f}")
    if not 0.4 < post_sd / exact_sd < 2.5:
        fails.append(f"smc2 sd ratio {post_sd / exact_sd:.2f}")
    if not res["rejuvenations"] >= 1:
        fails.append("smc2 never rejuvenated")
    if not abs(out["log_evidence"] - exact_ev) < 1.5:
        fails.append(f"smc2 evidence {out['log_evidence']:.3f} vs {exact_ev:.3f}")
    return out, fails


def check_particle(device="cuda", n_particles=512, pmmh_samples=800, pmmh_chains=4,
                   n_theta=128, n_x=128):
    """Example 13 (filter + PMMH on the SIR model) and SMC^2."""
    dev = prepare_device(device)
    ys = _sir_data()
    init_fn, step_fn, loglik_fn = _sir_fns()
    out, fails = {"n_particles": n_particles, "pmmh": [pmmh_chains, pmmh_samples]}, []
    with _Measure(dev) as m:
        gen = torch.Generator(device=dev).manual_seed(0)
        pf = particle_filter(init_fn, step_fn, loglik_fn, ys, n_particles, gen,
                             {"beta": SIR["TRUE_BETA"]})
        out["log_marginal_at_truth"] = float(pf["log_marginal"])
        out["min_ess"] = float(pf["ess"].min())
        lm = make_log_marginal_fn(init_fn, step_fn, loglik_fn, ys, n_particles)

        def log_marginal(g, theta):
            return lm(g, {"beta": torch.exp(theta[..., 0])})

        def log_prior(theta):
            return -0.5 * ((theta[..., 0] - math.log(0.3)) / 0.7) ** 2

        thetas, accept = pmcmc(log_marginal, log_prior, torch.tensor([math.log(0.3)]),
                               pmmh_samples, torch.Generator(device=dev).manual_seed(1),
                               step_scale=0.15, num_chains=pmmh_chains)
        betas = np.exp(thetas[:, pmmh_samples // 4:, 0].cpu().numpy())
    out.update(beta_mean=float(betas.mean()), beta_sd=float(betas.std()),
               accept=float(accept.mean()), pmmh_wall_s=m.wall_s, peak_mb=m.peak_mb)
    if not abs(out["beta_mean"] - SIR["TRUE_BETA"]) < 0.08:
        fails.append(f"beta mean {out['beta_mean']:.3f} vs {SIR['TRUE_BETA']}")
    if not 0.05 < out["accept"] < 0.8:
        fails.append(f"PMMH accept {out['accept']:.2f}")
    with _Measure(dev) as m:
        out["smc2"], smc_fails = _smc2_check(dev, n_theta, n_x)
    out["smc2"]["wall_s"] = m.wall_s
    out["wall_s"] = out["pmmh_wall_s"] + m.wall_s
    return _result("families:particle", out, fails + smc_fails)


# ---------------------------------------------------------------------------
# the exact-invariance battery on the device's tree
# ---------------------------------------------------------------------------

ALPHA = 0.005   # family-wise, Holm-controlled


def holm_reject(pvals, alpha=ALPHA):
    """Holm step-down: True if ANY hypothesis is rejected."""
    p = np.sort(np.asarray(pvals))
    return any(pi < alpha / (len(p) - i) for i, pi in enumerate(p))


def stouffer(pmat):
    """Combine an (R, n_stats) p-value matrix across replicates into
    upper-tail p-values, one per statistic."""
    pmat = np.clip(np.asarray(pmat), 1e-300, 1.0)
    return st.norm.sf(st.norm.isf(pmat).sum(axis=0) / np.sqrt(pmat.shape[0]))


def battery_pvalues(x, cov=None):
    """KS p-values: per-dim marginal, whitened radius^2 vs chi2(d), and a
    fixed linear functional."""
    d = x.shape[1]
    cov = np.eye(d) if cov is None else np.asarray(cov)
    sds = np.sqrt(np.diag(cov))
    pvals = [st.kstest(x[:, i] / sds[i], "norm").pvalue for i in range(d)]
    white = x @ np.linalg.inv(np.linalg.cholesky(cov)).T
    pvals.append(st.kstest(np.sum(white ** 2, axis=1), "chi2", args=(d,)).pvalue)
    u = np.arange(1, d + 1, dtype=np.float64)
    u /= np.linalg.norm(u)
    pvals.append(st.kstest(x @ u / float(np.sqrt(u @ cov @ u)), "norm").pvalue)
    return pvals


def invariance_run(vag, d, eps, seed, dev, n_chains=8192, k_steps=8, chol=None,
                   max_depth=6, syncs=None):
    """N exact-init chains x K transitions of the port's tree: final
    states (N, d) as f64 numpy and the mean accept statistic."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(n_chains, d, generator=gen, device=dev)
    if chol is not None:
        q = q @ torch.as_tensor(chol, dtype=torch.float32, device=dev).T
    metric = make_metric(torch.ones(n_chains, d, device=dev))
    eps_t = torch.full((n_chains,), eps, device=dev)
    logp, grad = vag(q)
    accs = []
    for _ in range(k_steps):
        q, logp, grad, s = nuts_transition(vag, metric, eps_t, q, logp, grad, max_depth,
                                           generator=gen, syncs=syncs)
        accs.append(s["accept_prob"])
    return q.double().cpu().numpy(), float(torch.stack(accs).mean())


def invariance_targets(dev):
    """(name, vag, d, eps, base_seed, chol, cov) of the battery's two
    targets (``tests/test_exact_invariance.py``)."""
    d2, rho = 3, 0.8
    cov = np.full((d2, d2), rho) + (1 - rho) * np.eye(d2)
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32, device=dev)

    def iso(q):
        return -0.5 * torch.sum(q * q, dim=-1), -q

    def corr(q):
        pq = q @ prec
        return -0.5 * torch.sum(q * pq, dim=-1), -pq

    return [("iso_gaussian", iso, 4, 0.7, 0, None, None),
            ("correlated_gaussian", corr, d2, 0.35, 2, np.linalg.cholesky(cov), cov)]


def check_invariance(device="cuda", n_chains=8192, replicates=4, k_steps=8):
    dev = prepare_device(device)
    out, fails = {"n_chains": n_chains, "replicates": replicates, "k_steps": k_steps}, []
    syncs = HostSyncs()
    with _Measure(dev) as m:
        for name, vag, d, eps, base, chol, cov in invariance_targets(dev):
            pmat, accs = [], []
            for r in range(replicates):
                x, acc = invariance_run(vag, d, eps, base + 1000 * r, dev, n_chains,
                                        k_steps, chol=chol, syncs=syncs)
                pmat.append(battery_pvalues(x, cov))
                accs.append(acc)
            pcomb = stouffer(pmat)
            out[name] = {"combined_p": [float(p) for p in pcomb],
                         "accept": float(np.mean(accs)), "holm_reject": holm_reject(pcomb)}
            if holm_reject(pcomb):
                fails.append(f"{name}: Holm rejects, combined p {out[name]['combined_p']}")
            if not all(0.5 < a < 1.0 for a in accs):
                fails.append(f"{name}: accept {accs}")
    out.update(wall_s=m.wall_s, peak_mb=m.peak_mb, host_syncs=syncs.count)
    return _result("tree:invariance", out, fails)


CHECKS = {"families:inla_t5000": check_inla, "families:smoothness": check_smoothness,
          "families:sv_marginal": check_sv_marginal, "families:ar_kalman": check_ar_kalman,
          "families:hmm": check_hmm, "families:gp_glm": check_gp_glm,
          "families:particle": check_particle, "tree:invariance": check_invariance}


def run_task(task, device="cuda"):
    """One task: a list of result dicts with their phase."""
    return [dict(phase="families", **CHECKS[task](device))]


def main(argv=None):
    ap = argparse.ArgumentParser(description="Drive the port's model families.")
    ap.add_argument("--task", action="append", choices=TASKS,
                    help="a task to run (repeatable; default: all)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ok = True
    for task in args.task or TASKS:
        for res in run_task(task, args.device):
            ok = ok and res["ok"]
            print(json.dumps(res), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
