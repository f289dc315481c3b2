"""The counterparts of ``tests/test_marginal.py``'s four INLA tests on
the port, on the CPU, at their sizes and gates: ``sv_inla`` recovers
the generating hyperparameters at T = 500 (the default 40 x 40 grid as
one batch), ``grid_batch`` gives the single call's posterior, non-finite
grid corners get zero weight, and a grid that fails everywhere raises."""

import numpy as np
import pytest

from exmc_tpu.benchmarks.suite import sv_model as jsv_model
from exmc_tpu_torch.marginal import sv_inla
from test_torch_families import one_torch_thread  # noqa: F401 (autouse)


def _sv_returns(t):
    return np.asarray(jsv_model(t=t).nodes["r_obs"].op[2])


def test_sv_inla_recovers_truth_t500():
    t = 500
    res = sv_inla(_sv_returns(t), device="cpu")
    true_sigma = 0.15 * np.sqrt(100.0 / t)
    assert abs(res["sigma_mean"] - true_sigma) < 3.5 * res["sigma_sd"]
    assert res["nu_mean"] > 3.0
    assert np.isfinite(res["path_mean"]).all()
    assert (res["path_sd"] > 0).all()
    assert abs(res["posterior"].sum() - 1.0) < 1e-6


def test_sv_inla_grid_batch_parity():
    rng = np.random.default_rng(0)
    s = np.cumsum(rng.normal(0, 0.04, 120))
    r = np.exp(s) * rng.standard_t(8, 120)
    kw = dict(sigma_grid=np.geomspace(0.005, 0.2, 9), nu_grid=np.geomspace(2.0, 40.0, 9),
              newton_iters=8, device="cpu")
    a = sv_inla(r, **kw)
    b = sv_inla(r, grid_batch=16, **kw)
    for k in ("sigma_mean", "sigma_sd", "nu_mean", "nu_sd"):
        assert abs(a[k] - b[k]) < 1e-6 * max(abs(a[k]), 1e-9), k
    np.testing.assert_allclose(a["path_mean"], b["path_mean"], rtol=1e-5, atol=1e-7)


def test_sv_inla_masks_nonfinite_grid_corners():
    out = sv_inla(_sv_returns(120),
                  sigma_grid=np.concatenate([[1e-30], np.geomspace(0.01, 0.2, 8)]),
                  nu_grid=np.geomspace(2.0, 80.0, 8), newton_iters=10, grid_batch=16,
                  device="cpu")
    for k in ("sigma_mean", "sigma_sd", "nu_mean", "nu_sd"):
        assert np.isfinite(out[k]), (k, out[k])
    assert np.isfinite(out["path_mean"]).all()
    assert out["sigma_mean"] > 1e-6
    assert out["n_failed"] >= 1


def test_sv_inla_all_failed_grid_raises():
    with pytest.raises(ValueError, match="ALL"):
        sv_inla(_sv_returns(80), sigma_grid=np.array([1e-30, 1e-28]),
                nu_grid=np.array([1e-6, 1e-5]), newton_iters=6, device="cpu")
