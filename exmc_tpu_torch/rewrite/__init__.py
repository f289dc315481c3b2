"""Rewrite pipeline: 6 ordered IR -> IR passes (``exmc_tpu/rewrite``).

    1. attach_default_transforms
    2. lift_measurable_matmul
    3. lift_measurable_affine
    4. normalize_obs
    5. populate_obs_metadata
    6. non_centered_parameterization   (removable with ncp=False)
"""

from exmc_tpu_torch.rewrite.passes import (
    attach_default_transforms,
    lift_measurable_matmul,
    lift_measurable_affine,
    normalize_obs,
    populate_obs_metadata,
)
from exmc_tpu_torch.rewrite.ncp import non_centered_parameterization

PASSES = [
    attach_default_transforms,
    lift_measurable_matmul,
    lift_measurable_affine,
    normalize_obs,
    populate_obs_metadata,
    non_centered_parameterization,
]


def apply(ir, *, ncp=True):
    """Run the ordered pass pipeline (``ncp=False`` drops the NCP pass)."""
    passes = PASSES if ncp else PASSES[:-1]
    for p in passes:
        ir = p(ir)
    return ir
