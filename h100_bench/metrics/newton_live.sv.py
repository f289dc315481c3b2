"""The share of the Laplace marginal's Newton iterations that still
moved the mode (``stats["laplace"]["live_iters"]``: some chain's accepted
step moved its mode by more than the marginal's ``LIVE_TOL``, max-norm,
relative to 1 + max|s|) over the iterations run
(``stats["laplace"]["newton_iters"]``: the calls times the marginal's
fixed count), over the window's fits: how much
of the fixed-count Newton work runs after convergence. A program
without the counters has nothing to read."""


def read(run):
    fits = [f for f in run.fits if "laplace" in f.stats]
    iters = sum(f.stats["laplace"]["newton_iters"] for f in fits)
    if not iters:
        return None
    return 100.0 * sum(f.stats["laplace"]["live_iters"] for f in fits) / iters
