"""The 99th percentile of the scaled residual at the mode that the
Laplace marginal returned, max|grad loglik - Q s_hat| / (1 + max|grad
loglik|), over every point of every call of a fit, rounded up to a
quarter decade (``stats["laplace"]["mode_residual_p99"]``), the larger
of the window's fits: a cheaper Newton that stops finding the mode for
more than a hundredth of the points raises it. A percentile, not the
maximum: warmup's divergent leaves, far from the posterior, leave a few
modes unfound, and their residual swings from run to run. A program
without the counters has nothing to read."""


def read(run):
    fits = [f for f in run.fits if "laplace" in f.stats and f.stats["laplace"]["calls"]]
    if not fits:
        return None
    return max(f.stats["laplace"]["mode_residual_p99"] for f in fits)
