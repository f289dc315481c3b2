"""Level-set utilities for Bayesian geometric inverse problems
(``exmc_tpu/apps/physics/level_set.py``): smooth-Heaviside material
classification, a Laplacian smoothness prior and the model builder.

The prior's and the likelihood's densities get the sampler's (C, ny*nx)
batch of ``phi`` and return (C,). The likelihood applies the user's
``forward_fn``, written for one (ny, nx) field as in the JAX package,
one chain at a time with ``torch.func.vmap``, as the compiler applies
det callables; it is a ``Custom(..., align=False)``, so it reads
``phi`` with its chain axis as it is.
"""

import numpy as np
import torch
import torch.nn.functional as F

from exmc_tpu_torch import dists
from exmc_tpu_torch.ir import Builder

# log(sqrt(2 pi)), as the JAX code writes it
_HALF_LOG_2PI = 0.9189385332046727


def smooth_heaviside(phi, eps=1.0):
    """H_eps(phi) = 0.5 (1 + tanh(phi / eps))."""
    return 0.5 * (1.0 + torch.tanh(torch.as_tensor(phi) / eps))


def material_field(phi, kappa_a, kappa_b, eps=1.0):
    """kappa = kappa_a H(phi) + kappa_b (1 - H(phi))."""
    h = smooth_heaviside(phi, eps)
    return kappa_a * h + kappa_b * (1.0 - h)


def laplacian_prior_logpdf(ny, nx, lam=1.0):
    """Smoothness prior logp(phi) = -lam/2 sum((nabla^2 phi)^2) over the
    interior cells. Returns a ``Custom`` logpdf over a flattened
    (..., ny*nx) phi, with one value per leading index."""

    def logpdf(phi_flat, params):
        phi = phi_flat.reshape(*phi_flat.shape[:-1], ny, nx)
        lap = (
            -4.0 * phi
            + F.pad(phi, (0, 0, 1, 0))[..., :-1, :]
            + F.pad(phi, (0, 0, 0, 1))[..., 1:, :]
            + F.pad(phi, (1, 0, 0, 0))[..., :, :-1]
            + F.pad(phi, (0, 1, 0, 0))[..., :, 1:]
        )
        interior = lap[..., 1:-1, 1:-1]
        return -0.5 * lam * torch.sum(interior * interior, dim=(-2, -1))

    return logpdf


def build_inverse_model(forward_fn, data, *, ny, nx, noise_sigma=0.05, lam=1.0):
    """Bayesian geometric inverse problem::

        phi ~ LaplacianSmoothnessPrior(lam)
        sensors = forward_fn(phi)          # e.g. heat2d_solve + read_sensors
        data ~ Normal(sensors, noise_sigma)

    ``forward_fn(phi_2d) -> sensor vector`` is a differentiable torch
    function of ONE (ny, nx) field, as in the JAX package: the
    likelihood applies it to each chain's field with ``torch.func.vmap``,
    so it must use no in-place op and read nothing on the host. Returns
    the IR; phi is a (ny*nx,) free RV."""
    data = np.asarray(data, dtype=np.float32)
    log_sigma = float(np.log(np.float32(noise_sigma)))

    prior = dists.Custom(logpdf_fn=laplacian_prior_logpdf(ny, nx, lam), support="real")

    def likelihood(_x, params, data=None):
        phi = params["phi"]
        pred = torch.func.vmap(forward_fn)(phi.reshape(phi.shape[0], ny, nx))
        resid = (data - pred) / noise_sigma
        return torch.sum(-0.5 * resid * resid - log_sigma - _HALF_LOG_2PI, dim=-1)

    lik = dists.Custom(logpdf_fn=likelihood, support="real", align=False)

    ir = Builder.new_ir()
    ir = Builder.rv(ir, "phi", prior, {}, shape=(ny * nx,))
    # the likelihood as an observed Custom RV, so phi is the only free RV
    ir = Builder.rv(ir, "lik", lik, {"phi": "phi"})
    ir = Builder.obs(ir, "lik_obs", "lik", 0.0)
    ir = Builder.data(ir, data)
    return ir
