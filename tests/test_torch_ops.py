"""The port's fused-leapfrog op against the JAX package: the plain
PyTorch version (what the wrapper runs on CPU tensors) against the JAX
scan reference and the Pallas kernel in interpret mode, on the shapes of
tests/test_pallas_ops.py. One test, marked ``gpu``, holds the CUDA kernel
against the plain version and skips when no card is present."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from exmc_tpu.ops import fused_leapfrog_gaussian as jax_fused
from exmc_tpu.ops.fused_leapfrog import reference_leapfrog_gaussian as jax_ref
from exmc_tpu_torch.ops import fused_leapfrog_gaussian
from exmc_tpu_torch.ops.fused_leapfrog import reference_leapfrog_gaussian


def _inputs(c, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(c, d)).astype(np.float32),
            rng.normal(size=(c, d)).astype(np.float32),
            rng.normal(size=d).astype(np.float32),
            rng.uniform(0.5, 2.0, size=d).astype(np.float32),
            rng.uniform(0.5, 1.5, size=d).astype(np.float32))


@pytest.mark.parametrize("c,d,k", [(8, 4, 16), (16, 128, 64)])
def test_plain_matches_jax_reference_and_pallas(c, d, k):
    arrs = _inputs(c, d)
    eps = 0.05
    before = fused_leapfrog_gaussian.launches
    got = fused_leapfrog_gaussian(*(torch.as_tensor(a) for a in arrs), eps, k)
    ref = jax_ref(*(jnp.asarray(a) for a in arrs), eps, k)
    pallas = jax_fused(*(jnp.asarray(a) for a in arrs), eps, k, tile_c=c,
                       interpret=True)
    for want in (ref, pallas):
        for g, w, tol in zip(got, want, (1e-4, 1e-4, 1e-3)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                       rtol=1e-4)
    assert fused_leapfrog_gaussian.launches == before  # CPU: no launch


def test_energy_conservation():
    """Joint energy conserved over a long chain at small eps."""
    c, d, k = 8, 8, 400
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.normal(size=(c, d)), dtype=torch.float32)
    p = torch.as_tensor(rng.normal(size=(c, d)), dtype=torch.float32)
    ones = torch.ones(d)

    def joint(q, p):
        return -0.5 * (q * q).sum(-1) - 0.5 * (p * p).sum(-1)

    qf, pf, _ = fused_leapfrog_gaussian(q, p, torch.zeros(d), ones, ones, 0.01, k)
    np.testing.assert_allclose(joint(qf, pf).numpy(), joint(q, p).numpy(),
                               atol=2e-3)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "steps"])
def test_wrapper_rejects_bad_input(bad):
    q, p, mu, prec, inv = (torch.as_tensor(a) for a in _inputs(4, 6))
    k = 3
    if bad == "dtype":
        q = q.double()
    elif bad == "shape":
        mu = mu[:5]
    elif bad == "contiguous":
        q = torch.as_tensor(_inputs(6, 4)[0]).t()
    else:
        k = -1
    with pytest.raises((TypeError, ValueError)):
        fused_leapfrog_gaussian(q, p, mu, prec, inv, 0.05, k)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for c, d, k in [(8, 4, 16), (16, 128, 64), (37, 300, 10), (1024, 256, 32)]:
        arrs = [torch.as_tensor(a, device="cuda") for a in _inputs(c, d)]
        before = fused_leapfrog_gaussian.launches
        got = fused_leapfrog_gaussian(*arrs, 0.05, k)
        assert fused_leapfrog_gaussian.launches == before + 1
        want = reference_leapfrog_gaussian(*arrs, 0.05, k)
        torch.cuda.synchronize()
        for g, w, tol in zip(got, want, (1e-4, 1e-4, 1e-3)):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       atol=tol, rtol=1e-5)
