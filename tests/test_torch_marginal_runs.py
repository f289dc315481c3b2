"""The port's Laplace-marginal runs: NUTS on ``sv_marginal_model``
(the NUTS test of ``tests/test_marginal.py``, on the port on the CPU;
its INLA tests are in ``tests/test_torch_marginal_inla.py``), the float64 path
end to end (``config.x64()`` and ``EXMC_TPU_TORCH_X64=1``: the compiled
model, the trace, the step size and the Welford state), and the
marginal's value-and-grad replayed from a CUDA graph (card only).

The NUTS run is shorter than the JAX test's (T = 40, 2 chains, 50 + 50, 5 Newton
iterations, in float64; not T = 300, 4 chains, 300 + 300): each
value-and-grad of the marginal is a few thousand eager ops on the CPU.
The card runs example 45's full recipe (``benchmarks/families.py``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from exmc_tpu.benchmarks.suite import sv_model as jsv_model
import exmc_tpu_torch
from exmc_tpu_torch import config
from exmc_tpu_torch.diagnostics import rhat
from exmc_tpu_torch.marginal import sv_inla, sv_marginal_model
from test_torch_families import one_torch_thread  # noqa: F401 (autouse)


def _sv_returns(t):
    return np.asarray(jsv_model(t=t).nodes["r_obs"].op[2])


def test_sv_marginal_model_nuts():
    """NUTS on the 2-d marginalized model agrees with the INLA grid (the
    same approximation integrated two ways)."""
    r = _sv_returns(40)
    with config.x64():
        ir = sv_marginal_model(r, newton_iters=5)
        trace, stats = exmc_tpu_torch.sample(ir, ncp=False, num_chains=2, num_warmup=50,
                                             num_samples=50, seed=0, device="cpu")
        res = sv_inla(r, newton_iters=5, device="cpu")
    sig = trace["sigma"]
    assert sig.dtype == np.float64
    assert float(rhat(sig)) < 1.1
    assert abs(float(sig.mean()) - res["sigma_mean"]) < 3 * res["sigma_sd"]
    assert int(stats["divergences"].sum()) < 0.05 * 2 * 50


# ---------------------------------------------------------------------------
# float64 end to end; the card
# ---------------------------------------------------------------------------

def _scale_model():
    B, D = exmc_tpu_torch.Builder, exmc_tpu_torch.dists
    y = np.random.default_rng(1).normal(2.0, 1.5, size=30)
    ir = B.rv(B.new_ir(), "mu", D.Normal, {"mu": 0.0, "sigma": 5.0})
    ir = B.rv(ir, "sigma", D.HalfNormal, {"sigma": 2.0})
    ir = B.rv(ir, "y", D.Normal, {"mu": "mu", "sigma": "sigma"}, shape=(30,))
    return B.obs(ir, "y_obs", "y", y)


def test_x64_runs_compiler_and_nuts_in_float64(tmp_path):
    with config.x64():
        assert config.x64_enabled() and config.log_transform_clamp() == 200.0
        model = exmc_tpu_torch.compile_logp(_scale_model(), device="cpu")
        lp, g = model.value_and_grad(torch.zeros(2, model.size, dtype=torch.float64))
        assert lp.dtype == g.dtype == torch.float64
        s = exmc_tpu_torch.nuts.sampler.NUTSSampler(model, num_warmup=60, num_samples=40)
        ck = tmp_path / "ck.npz"
        trace, stats = s.run_chunked(num_chains=2, chunk_iters=50, seed=0,
                                     checkpoint_path=str(ck))
    assert not config.x64_enabled() and config.default_dtype() == torch.float32
    assert trace["mu"].dtype == trace["sigma"].dtype == np.float64
    assert stats["step_size"].dtype == np.float64 and stats["energy"].dtype == np.float64
    carry = np.load(ck)
    for k in ("carry.wf.mean", "carry.wf.m2", "carry.wf.n", "carry.q", "carry.da.log_eps"):
        assert carry[k].dtype == np.float64, k


def test_x64_environment_variable():
    code = ("from exmc_tpu_torch import config; import torch; "
            "assert config.default_dtype() == torch.float64; "
            "assert config.log_transform_clamp() == 200.0; print('ok')")
    env = dict(os.environ, EXMC_TPU_TORCH_X64="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.gpu
def test_marginal_value_and_grad_graphed_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = _sv_returns(400)
    ir = sv_marginal_model(r, newton_iters=10)
    gpu = exmc_tpu_torch.compile_logp(ir, ncp=False, device="cuda")
    cpu = exmc_tpu_torch.compile_logp(ir, ncp=False, device="cpu")
    x = torch.tensor([[np.log(0.05), np.log(10.0)], [np.log(0.1), np.log(5.0)]])
    lg, gg = gpu.value_and_grad(x.cuda())
    lg2, gg2 = gpu.value_and_grad(x.cuda())          # the replay
    lc, gc = cpu.value_and_grad(x)
    assert len(gpu.value_and_grad.graphs) == 1
    assert torch.equal(lg, lg2) and torch.equal(gg, gg2)
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-4)
    np.testing.assert_allclose(gg.cpu().numpy(), gc.numpy(), rtol=2e-3, atol=1e-3)
