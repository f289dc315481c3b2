"""Batched NUTS: leapfrog, dual averaging, Welford, warmup schedule,
the multinomial tree and the sampling pipeline."""

from exmc_tpu_torch.nuts.sampler import (
    NUTSSampler,
    sample,
    sample_chains,
    sample_stream,
)
from exmc_tpu_torch.nuts.tree import nuts_transition

__all__ = ["NUTSSampler", "sample", "sample_chains", "sample_stream",
           "nuts_transition"]
