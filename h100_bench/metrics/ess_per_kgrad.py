"""Mixing per gradient: the window's summed minimum bulk ESS over its
summed leapfrog steps of the draws (``stats["n_steps"]``), per thousand
steps. Warmup's steps are not returned by the program, so they are not
counted."""


def read(run):
    steps = sum(f.n_steps for f in run.fits)
    if not steps:
        return None
    return 1000.0 * sum(f.min_ess for f in run.fits) / steps
