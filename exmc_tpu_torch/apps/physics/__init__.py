"""PDE-constrained Bayesian inversion (``exmc_tpu/apps/physics``): a
differentiable 2-D heat solver, level-set fields and the inverse model."""

from exmc_tpu_torch.apps.physics.heat_2d import read_sensors
from exmc_tpu_torch.apps.physics.heat_2d import solve as heat2d_solve
from exmc_tpu_torch.apps.physics.level_set import (
    build_inverse_model,
    laplacian_prior_logpdf,
    material_field,
    smooth_heaviside,
)

__all__ = [
    "heat2d_solve",
    "read_sensors",
    "smooth_heaviside",
    "material_field",
    "laplacian_prior_logpdf",
    "build_inverse_model",
]
