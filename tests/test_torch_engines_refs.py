"""The JAX package's results for the approximate engines on the gold
``stan_logistic_d21``, which
``exmc_tpu_torch.benchmarks.engines.APPROX_REFERENCES`` stores as
constants (the port never imports JAX to get them), and the engines
benchmark's checks at a small size on the CPU.

Regenerate the constants on the CPU with

    JAX_PLATFORMS=cpu python tests/test_torch_engines_refs.py

which runs the JAX package's ``fit_map``, ``laplace(psir=True)``,
``advi_fit`` (SGD, Adam) and ``pathfinder_fit`` (diag, lowrank) with the
engines benchmark's options, seeds 0-5 where the result is random, and
prints ``APPROX_REFERENCES`` to paste into the port. The tolerances:

* the MAP: 1e-3 of max(1, |beta|) (a converged L-BFGS on a strictly
  concave density; the starts differ between the packages' generators);
* the Laplace log-determinant: 1e-3 relative (a deterministic Hessian
  at the MAP); k-hat < 0.7 and ESS_IS > 25 % of the draws (JAX's seeds
  0-2 give k-hat 0.06-0.43, ESS_IS 495-635 of 1000);
* ADVI: every coordinate's mu within ``advi_mu_tol_sd`` of JAX's seed-0
  sigma from JAX's seed-0 mu, and sigma within a factor
  ``advi_sigma_tol``: JAX's own seeds 1-4 against seed 0 reach 1.22
  sd and 0.82-1.21 (SGD), 0.58 sd and 0.82-1.21 (Adam);
* Pathfinder: the best ELBO within JAX's seeds' range widened by a
  quarter of its width (the fit depends on the random start). JAX's
  lowrank path never leaves its start on this model: its first
  damped-Newton step reaches beta where the Bernoulli-of-sigmoid
  likelihood's gradient is NaN, every step is rejected, and with PSIR
  k-hat is 57-62 and ESS_IS 1. The port reproduces that (sigma = 1, k-hat
  > 0.7), and the benchmark holds it to that.
"""

import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # run as a script from any directory
    sys.path.insert(0, str(ROOT))

from exmc_tpu import stan as jstan  # noqa: E402
from exmc_tpu.advi import advi_fit as j_advi  # noqa: E402
from exmc_tpu.optimize import fit_map as j_fit_map, laplace as j_laplace  # noqa: E402
from exmc_tpu.pathfinder import pathfinder_fit as j_pathfinder  # noqa: E402
from exmc_tpu_torch.benchmarks import engines  # noqa: E402
from exmc_tpu_torch.benchmarks import gold_models  # noqa: E402

ADVI_MU_TOL_SD, ADVI_SIGMA_TOL = 2.0, 1.4


def _r(x, n=6):
    return [float(f"{v:.{n}g}") for v in np.asarray(x, np.float64).reshape(-1)]


def jax_references(seeds=range(6), advi_steps=5000, pf_iters=100, draws=1000):
    """APPROX_REFERENCES from the JAX package on stan_logistic_d21."""
    ir = jstan.compile(gold_models.STAN_LOGISTIC, gold_models.stan_logistic_d21_data())
    point, info = j_fit_map(ir, seed=engines.SEED)
    assert info["converged"]
    _, lap = j_laplace(ir, seed=engines.SEED, draws=draws, psir=True)
    out = {"map_beta": _r(point["beta"]), "laplace_cov_logdet": float(lap["cov_logdet"]),
           "laplace_pareto_k": float(lap["psir"]["pareto_k"]),
           "laplace_ess_is": float(lap["psir"]["ess_is"]),
           "advi_mu_tol_sd": ADVI_MU_TOL_SD, "advi_sigma_tol": ADVI_SIGMA_TOL}
    for opt in ("sgd", "adam"):
        fit = j_advi(ir, num_steps=advi_steps, seed=0, optimizer=opt, num_draws=draws)
        out[f"advi_{opt}"] = {"mu": _r(fit["mu"]), "sigma": _r(fit["sigma"]),
                              "steps_run": int(fit["steps_run"])}
    for method in ("diag", "lowrank"):
        best = [float(np.max(j_pathfinder(ir, num_iters=pf_iters, num_draws=draws, seed=s,
                                          method=method)["elbo_path"])) for s in seeds]
        out[f"pathfinder_{method}_best_elbo_range"] = [round(min(best), 3),
                                                       round(max(best), 3)]
    return out


def test_generator_at_a_small_size():
    refs = jax_references(seeds=range(2), advi_steps=200, pf_iters=10, draws=100)
    assert len(refs["map_beta"]) == 21 and np.isfinite(refs["laplace_cov_logdet"])
    assert len(refs["advi_adam"]["mu"]) == 21
    lo, hi = refs["pathfinder_diag_best_elbo_range"]
    assert lo <= hi


def test_stored_references():
    refs = engines.APPROX_REFERENCES
    assert sorted(refs) == sorted([
        "map_beta", "laplace_cov_logdet", "laplace_pareto_k", "laplace_ess_is",
        "advi_mu_tol_sd", "advi_sigma_tol", "advi_sgd", "advi_adam",
        "pathfinder_diag_best_elbo_range", "pathfinder_lowrank_best_elbo_range"])
    assert len(refs["map_beta"]) == 21
    assert refs["advi_mu_tol_sd"] == ADVI_MU_TOL_SD
    assert refs["advi_sigma_tol"] == ADVI_SIGMA_TOL
    assert refs["laplace_pareto_k"] < 0.7
    for opt in ("sgd", "adam"):
        assert len(refs[f"advi_{opt}"]["sigma"]) == 21


def main():
    import json

    print("APPROX_REFERENCES = " + json.dumps(jax_references(), indent=4))


if __name__ == "__main__":
    main()


@pytest.mark.parametrize("task", ["eight_schools:chees", "corrblock128:meads",
                                  "scaled32:snaper"])
def test_engine_rows_on_cpu(task):
    """An engine row at 32 chains, 60+40 on the CPU: the fields the card
    run reports, and the MEADS/ChEES sync counts."""
    name, engine = task.split(":")
    row = engines.run_engine(name, engine, "cpu", chains=32, warmup=60, draws=40,
                             warm_run=(3, 3))
    assert row["finite"] and row["min_ess"] > 0
    assert row["gated"] == ((name, engine) not in engines.FINITE_ONLY)
    for key in ("wall_s", "min_ess_per_s", "max_rhat", "divergence_rate", "peak_mb"):
        assert key in row
    if engine == "meads":
        assert row["syncs_per_iter"] < 0.05 and len(row["step_size"]) == 4
    else:
        assert 1.0 <= row["syncs_per_iter"] < 1.2 and row["num_steps_mean"] >= 1


def test_gates_hold_the_engine_rows():
    s = {"finite": True, "max_rhat": 1.01, "divergence_rate": 0.0,
         "means": {"mu": 4.41, "tau": 3.2}, "sds": {}, "mcse": {}}
    assert engines.gate_failures("eight_schools", "chees", s) == [
        "tau mean 3.200 not within 0.3 of 3.6"]
    assert engines.gate_failures("eight_schools", "meads", s) == []
    cols = {f"x[{i}]": 0.0 for i in range(32)}
    s = {"finite": False, "max_rhat": 1.2, "divergence_rate": 0.01, "means": dict(cols),
         "mcse": {k: 0.1 for k in cols},
         "sds": {f"x[{i}]": float(v) for i, v in enumerate(np.linspace(1, 10, 32))}}
    s["means"]["x[3]"] = 0.5
    s["sds"]["x[5]"] *= 1.2
    assert engines.gate_failures("scaled32", "chees", s) == [
        "non-finite draws", "max R-hat 1.2000", "divergence rate 0.01",
        "means beyond 4 MCSE of 0 at [3]", "sds off by > 10 % at [5]"]


def test_approx_checks_on_cpu():
    """The library checks at a small size on the CPU: fit_map equal to
    itself and to the JAX MAP, Laplace meeting the gold's criterion,
    lowrank Pathfinder stuck at its start as JAX's is."""
    rows = {r["check"]: r for r in engines.check_approx(
        "cpu", advi_steps=200, pf_iters=20, draws=200)}
    assert len(rows) == 9
    for name, row in rows.items():
        if name.startswith(("fit_map", "laplace", "pathfinder_fit(lowrank")):
            assert row["ok"], row
    assert rows["pathfinder_fit(lowrank, psir)"]["pareto_k"] > 0.7
    assert rows["advi_fit(adam)"]["host_syncs"] == 2


def test_cli_and_pathfinder_init_checks_on_cpu():
    res = engines.check_cli_approx("cpu", iters=200)
    assert res["ok"], res
    assert res["optimize_report"].startswith("MAP (converged")
    res = engines.check_pathfinder_init("cpu", chains=8, warmup=30, samples=20,
                                        gates=False)
    assert res["ok"] and res["init_spread"] > 0
