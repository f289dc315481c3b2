"""The device's idle share over the profiled fit after the window (a
whole fit of the recipe, or the traffic's shorter ``profile_fit`` at the
window's chains where a whole one holds too many device operations to
trace): 1 less the union of its kernel, copy and fill intervals over the
fit's seconds."""


def read(run):
    p = run.profile
    if not p or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
