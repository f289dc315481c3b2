"""Device milliseconds of one call of the model's value-and-grad, from
the profiled fit's trace: the union of the intervals of the kernels that
the CUDA graph launches ran, over the number of launches. The port's
``GraphedValueAndGrad`` is the only graph a NUTS fit launches, so this
is the model's own device work per call, without the host's cost of
issuing it."""


def read(run):
    p = run.profile
    if not p or not p.get("graph_launches") or not p.get("graph_busy_s"):
        return None
    return 1000.0 * p["graph_busy_s"] / p["graph_launches"]
