"""The port's model-family modules stand alone, and the card's
``families`` tasks (``exmc_tpu_torch/benchmarks/families.py``) run on the
CPU at small sizes: the same code paths ``chip_smoke.py``'s pool runs at
the examples' full settings. ``chip_smoke.py`` schedules every task."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from exmc_tpu_torch.benchmarks import families

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the module's torch ops on one thread. The tests run in several
    worker processes on one CPU, and with torch's default of an OpenMP
    thread per core in each process the idle threads busy-wait: a loop of
    small ops then crawls (the 600-step PMMH test took 11 s alone and
    did not finish in 15 min beside five workers running these files on
    an 8-core CPU). The other model-family test files import this
    fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
MODULES = ["kalman", "glm", "gp", "hmm", "marginal", "particle.filter", "particle.pmcmc",
           "particle.smc2", "benchmarks.families"]


@pytest.mark.parametrize("mod", MODULES)
def test_family_module_source_names_no_jax(mod):
    src = open(os.path.join(ROOT, "exmc_tpu_torch", *mod.split(".")) + ".py").read()
    assert not re.search(r"^\s*(import jax|from jax)", src, re.M)
    assert not re.search(r"^\s*(import exmc_tpu\b|from exmc_tpu[ .])", src, re.M)


def test_family_modules_import_no_jax():
    code = ("import sys; " + "; ".join(f"import exmc_tpu_torch.{m}" for m in MODULES) + "; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'exmc_tpu' or m.startswith('exmc_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_inla_and_transect_tasks_small():
    res = families.check_inla("cpu", t=120, newton_iters=8, grid=6, ref=None)
    assert res["ok"] and res["n_failed"] == 0 and res["dtype"] == "float64"
    assert 0 < res["sigma_mean"] < 0.2
    res = families.check_smoothness("cpu", t=150, points=16, newton_iters=6,
                                    timing_t=(60,), timing_reps=1)
    assert res["finite_f32"] and res["finite_f64"]
    assert res["d3_std_f64"] < res["d3_std_f32"]
    assert res["vag_ms_T60_f32"] > 0 and res["vag_ms_T60_f64"] > 0


def test_particle_task_small():
    res = families.check_particle("cpu", n_particles=64, pmmh_samples=30, pmmh_chains=2,
                                  n_theta=32, n_x=32)
    assert np.isfinite(res["log_marginal_at_truth"]) and 0.0 < res["accept"] < 1.0
    assert res["smc2"]["host_syncs"] == 40


def test_invariance_task_small():
    res = families.check_invariance("cpu", n_chains=512, replicates=2, k_steps=2)
    assert res["ok"], res
    assert res["host_syncs"] > 0
    assert len(res["iso_gaussian"]["combined_p"]) == 6


def test_chip_smoke_schedules_every_family_task():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    tasks = chip_smoke.pool_tasks()
    assert [t for k, t in tasks if k == "families"] and \
        {t for k, t in tasks if k == "families"} == set(families.TASKS)
    assert {t for k, t in chip_smoke.POOL_COST_S if k == "families"} == set(families.TASKS)
    assert chip_smoke.N_FAMILIES_ROWS == len(families.TASKS) == 8
    with pytest.raises(SystemExit):
        families.main(["--task", "families:nope"])
