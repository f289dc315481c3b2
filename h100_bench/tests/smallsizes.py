"""Cells cut to sizes that a CPU test can hold, with the moment limits
that those sizes need (fewer draws, so wider sampling noise); the limits
on the log-density and the gradient stay the cell's own."""

from h100_bench import harness

SMALL = {
    "eight_schools.nuts": ({"chains": 16, "warmup": 60, "draws": 40,
                            "init": ["superchain", 4], "warm_up_fit": [5, 5]}, {}),
    "covtype_logistic.nuts": ({"chains": 8, "warmup": 60, "draws": 40,
                               "warm_up_fit": [5, 5]}, {"rows": 3000}),
}
# the moments of a few hundred draws: at most 4 Monte Carlo standard
# errors from the reference's means, sds within 40 %
SMALL_LIMITS = {"mean_z": 4.0, "sd_gap": 0.4}


def small_spec(workload):
    spec = harness.Spec.load(harness.HERE.parent, workload)
    traffic, cfg = SMALL[workload]
    spec.traffic.update(traffic)
    spec.cfg.update(cfg)
    spec.limits.update(SMALL_LIMITS)
    return spec
