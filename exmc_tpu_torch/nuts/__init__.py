"""Batched NUTS: leapfrog, dual averaging, Welford, warmup schedule,
the multinomial tree and the sampling pipeline."""

from exmc_tpu_torch.nuts.mass_matrix import (
    WelfordState,
    welford_finalize,
    welford_init,
    welford_update,
)
from exmc_tpu_torch.nuts.sampler import (
    NUTSSampler,
    sample,
    sample_chains,
    sample_stream,
)
from exmc_tpu_torch.nuts.step_size import (
    DualAveragingState,
    da_init,
    da_update,
    find_reasonable_epsilon,
)
from exmc_tpu_torch.nuts.tree import build_nuts_kernel, nuts_transition

__all__ = [
    "sample",
    "sample_chains",
    "sample_stream",
    "build_nuts_kernel",
    "DualAveragingState",
    "da_init",
    "da_update",
    "find_reasonable_epsilon",
    "WelfordState",
    "welford_init",
    "welford_update",
    "welford_finalize",
    "NUTSSampler",
    "nuts_transition",
]
