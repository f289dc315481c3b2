"""The ``sv_marginal.nuts`` cell on the CPU at a small size (T = 64, 4
chains, 4 Newton iterations): a sound run is correct and reads its three
per-layer counters; the control (the reference in float32) and each
fault planted underneath are not; the reference's log-density and
gradient equal the port's float64 marginal, and its posterior the
NUTS moments' scale."""

import numpy as np
import pytest
import torch

from h100_bench import faults, harness

CELL = "sv_marginal.nuts"
SEED = 2**31 + 41


def _spec():
    spec = harness.Spec.load(harness.HERE.parent, CELL)
    spec.traffic.update({"chains": 4, "warmup": 60, "draws": 40, "warm_up_fit": [3, 3]})
    # a short series of its own, on which float32 already misses
    spec.cfg.update({"T": 64, "newton_iters": 8, "data_seed": SEED})
    # the moments of 160 draws: at most 4 Monte Carlo standard errors
    # from the reference's means, sds within 40 %
    spec.limits.update({"mean_z": 4.0, "sd_gap": 0.4})
    return spec


def _run(fault=None):
    spec, keep = _spec(), {}
    with faults.planted(fault):
        result, compared = harness.run_cell(spec, SEED, 0.1, False, device="cpu", keep=keep)
    return spec, result, compared, keep


def test_a_sound_run_is_correct_and_its_control_is_not():
    spec, result, compared, keep = _run()
    assert result["correct"], compared
    ref = harness.load_module(harness.HERE / "reference" / "sv_marginal.py")
    control = harness.compare(spec, keep["fits"], keep["data"], None, "cpu",
                              precision=ref.CONTROL)
    assert any(control[k] > spec.limits[k] for k in ("logp_gap", "grad_gap")), control
    run = harness.Run(spec=spec, config=None, fits=keep["fits"], device="cpu")
    assert 0.0 < run.value("newton_live.sv") <= 100.0
    assert np.isfinite(run.value("mode_residual.sv"))
    assert run.value("newton_ms.sv") is None            # no device trace on the CPU


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_planted_fault_is_not_correct(fault):
    _, result, compared, _ = _run(fault)
    assert not result["correct"], (fault, compared)


def test_logp_and_grad_equal_the_ports_float64_marginal():
    import exmc_tpu_torch

    spec = _spec()
    config = harness.load_module(spec.cfg_path.with_suffix(".py"))
    ref = harness.load_module(harness.HERE / "reference" / "sv_marginal.py")
    spec.cfg["newton_iters"] = 30
    ir, data = config.build(spec.cfg, SEED, "cpu")
    model = exmc_tpu_torch.compile_logp(ir, device="cpu")
    gen = torch.Generator().manual_seed(5)
    flat = torch.stack([torch.log(torch.tensor(10.0)) + 0.5 * torch.randn(8, generator=gen),
                        torch.log(torch.tensor(0.03)) + 0.5 * torch.randn(8, generator=gen)], 1)
    order = [e.id for e in model.pm.entries]
    flat = flat[:, [["nu", "sigma"].index(k) for k in order]]
    lp, g = model.value_and_grad(flat)
    u = {e.id: flat[:, e.offset].double().numpy() for e in model.pm.entries}
    lp_ref, g_ref = ref.logp_and_grad(u, data, spec.cfg, "float64", "cpu")
    # the program reports float32: its log-density to a few ulps of ~250
    # nats, its gradient to float32's rounding of the float64 marginal's
    assert np.abs(lp.double().numpy() - lp_ref).max() < 1e-4
    g_flat = np.stack([g_ref[k] for k in order], 1)
    assert np.abs(g.double().numpy() - g_flat).max() < 1e-5 * np.abs(g_flat).max() + 1e-5
