"""The Laplace-marginal stochastic-volatility model built through the
port's ``marginal.sv_marginal_model``, as ``sv_marginal.json`` states it:
a float64 marginal under the float32 sampler. The returns are one
series, drawn here from the configuration's ``data_seed`` by the
generative process of the port's suite SV model (the same numbers as
``suite.sv_model(t=T)``, whose default seed it is); a run's seed drives
the sampler alone, as a deployment fits one return series with fresh
chains. The same array goes to the program and to the reference."""

import numpy as np
import torch

from exmc_tpu_torch.marginal import sv_marginal_model


def returns(T, seed):
    """(T,) float64 returns: a Gaussian random walk s with innovation sd
    0.15 sqrt(100 / T), and StudentT(10) shocks scaled by exp(s), rounded
    to float32."""
    rng = np.random.default_rng(int(seed))
    s = np.cumsum(rng.normal(0, 0.15 * float(np.sqrt(100.0 / T)), size=T))
    return (rng.standard_t(10, size=T) * np.exp(s)).astype(np.float32).astype(np.float64)


def build(cfg, seed, device):
    """(ir, data): the model's IR and the returns the reference reads;
    ``seed`` is the sampler's, not the data's."""
    r = returns(cfg["T"], cfg["data_seed"])
    ir = sv_marginal_model(r, newton_iters=cfg["newton_iters"], dtype=torch.float64)
    return ir, {"r": r}
