"""Host syncs of the NUTS tree per iteration (warmup and draws), summed
over the window's fits: the count of tree leaves the deepest chain
needed, as the cached sampler's ``last_run`` holds it."""


def read(run):
    fits = [f for f in run.fits if f.host_syncs is not None and f.iterations]
    if not fits:
        return None
    return sum(f.host_syncs for f in fits) / sum(f.iterations for f in fits)
