"""Whole runs of the harness on the CPU at small sizes: a sound run is
correct; each fault planted underneath, and the control in the
program's place, is not. The runs skip the harness's look for a card
and drive the rest: set-up, window, comparison."""

import pytest

from h100_bench import faults, harness
from smallsizes import small_spec

CELLS = ["eight_schools.nuts", "covtype_logistic.nuts"]
SEED = 2**31 + 17


def _run(cell, fault=None, seed=SEED):
    spec = small_spec(cell)
    keep = {}
    with faults.planted(fault):
        result, compared = harness.run_cell(spec, seed, 0.1, False, device="cpu", keep=keep)
    return spec, result, compared, keep


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_its_control_is_not(cell):
    spec, result, compared, keep = _run(cell)
    assert result["correct"], compared
    assert result["attempted"] == 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "ess_per_s", "fit_s"}
    ref = harness.load_module(harness.HERE / "reference" / f"{spec.cell['config']}.py")
    control = harness.compare(spec, keep["fits"], keep["data"], None, "cpu",
                              precision=ref.CONTROL)
    assert any(control[k] > spec.limits[k] for k in ("logp_gap", "grad_gap")), control


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cell, fault):
    _, result, compared, _ = _run(cell, fault)
    assert not result["correct"], (fault, compared)


def test_no_forbidden_module_in_a_run():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, 'h100_bench/tests'); sys.path.insert(0, '.');"
            "from smallsizes import small_spec; from h100_bench import harness, faults;"
            "import h100_bench.calibrate, h100_bench.device_trace;"
            "harness.run_cell(small_spec('covtype_logistic.nuts'), 3, 0.1, False, device='cpu');"
            "[harness.load_module(p) for d in ('metrics', 'reference', 'configs')"
            " for p in (harness.HERE / d).glob('*.py')];"
            "print('FORBIDDEN', harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.HERE.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "FORBIDDEN []"


def test_the_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "exmc_tpu_torch_like", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax"]
