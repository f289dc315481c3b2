"""Device milliseconds of one Newton iteration of the Laplace marginal:
the profiled fit's device time per CUDA graph launch (as ``vag_ms``
reads it) over the Newton iterations a value-and-grad call runs, from
the window's counters (``stats["laplace"]``: iterations over calls),
plus one for the backward's solve at the mode. A faster iteration moves
it; stopping Newton early does not. A program without the counters has
nothing to read."""


def read(run):
    p = run.profile
    fits = [f for f in run.fits if "laplace" in f.stats and f.stats["laplace"]["calls"]]
    if not p or not p.get("graph_launches") or not p.get("graph_busy_s") or not fits:
        return None
    per_call = (sum(f.stats["laplace"]["newton_iters"] for f in fits)
                / sum(f.stats["laplace"]["calls"] for f in fits))
    return 1000.0 * p["graph_busy_s"] / p["graph_launches"] / (per_call + 1.0)
