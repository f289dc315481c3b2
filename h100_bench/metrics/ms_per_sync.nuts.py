"""Milliseconds of a whole fit per host sync of the NUTS tree, over the
window's fits (none of them profiled): what a tree leaf costs end to
end, the model's call, the tree's eager operations and the wait."""


def read(run):
    fits = [f for f in run.fits if f.host_syncs]
    if not fits:
        return None
    return 1000.0 * sum(f.seconds for f in fits) / sum(f.host_syncs for f in fits)
