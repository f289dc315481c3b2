"""Eight schools (Rubin 1981) built through the port's public ``Builder``,
as ``eight_schools.json`` states it. The data are published; the seed
changes nothing here."""

import numpy as np

from exmc_tpu_torch import Builder, dists


def build(cfg, seed, device):
    """(ir, data): the model's IR and the numbers the reference reads."""
    y, sigma = cfg["y"], cfg["sigma"]
    ir = Builder.new_ir()
    ir = Builder.rv(ir, "mu", dists.Normal, {"mu": 0.0, "sigma": cfg["mu_prior_sd"]})
    ir = Builder.rv(ir, "tau", dists.HalfCauchy, {"scale": cfg["tau_prior_scale"]})
    for j in range(cfg["J"]):
        ir = Builder.rv(ir, f"theta_{j}", dists.Normal, {"mu": "mu", "sigma": "tau"})
        ir = Builder.rv(ir, f"y_{j}", dists.Normal,
                        {"mu": f"theta_{j}", "sigma": sigma[j]})
        ir = Builder.obs(ir, f"y_{j}_obs", f"y_{j}", y[j])
    return ir, {"y": np.asarray(y, np.float64), "sigma": np.asarray(sigma, np.float64)}
