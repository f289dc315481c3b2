"""Particle-filter stack: bootstrap PF -> PMCMC -> SMC^2
(``exmc_tpu/particle``), for state-space models whose likelihood has no
closed form (discrete transitions, SEIR, regime switching).

The JAX package vmaps filters over parameter points; here a batch of B
points' filters runs as one filter over B * n particles, its weights
and resampling kept per point. Model callables take a
``torch.Generator`` where the JAX package's take a key.
"""

from exmc_tpu_torch.particle.filter import particle_filter, systematic_resample
from exmc_tpu_torch.particle.pmcmc import pmcmc
from exmc_tpu_torch.particle.smc2 import smc2

__all__ = ["particle_filter", "systematic_resample", "pmcmc", "smc2"]
