"""The share of the rows of the NUTS tree's batched value-and-grad calls
that advanced a live chain, over the window's fits: every chain's
leapfrog steps, those of the warmup (``stats["n_steps_warmup"]``) and of
the draws (``stats["n_steps"]``), over the tree's calls
(``stats["vag_calls"]["leaf"]``) times the chains. Each leaf evaluates
every chain; the rows of chains that have finished their tree are
masked, and this is what is left of the work."""

import numpy as np


def read(run):
    fits = [f for f in run.fits if "n_steps_warmup" in f.stats and "vag_calls" in f.stats]
    rows = sum(f.stats["vag_calls"]["leaf"] * np.asarray(f.stats["n_steps_warmup"]).size
               for f in fits)
    if not rows:
        return None
    live = sum(int(np.asarray(f.stats["n_steps_warmup"]).sum()) + f.n_steps for f in fits)
    return 100.0 * live / rows
