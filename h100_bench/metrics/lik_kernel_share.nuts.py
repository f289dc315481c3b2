"""The share of the window's value-and-grad calls, over every site,
whose graph holds the Bernoulli-logit GLM likelihood kernel
(``stats["vag_calls_lik_kernel"]``) over all of them (the sum of
``stats["vag_calls"]``), over the window's fits. A program without the
counter has nothing to read."""


def read(run):
    fits = [f for f in run.fits if "vag_calls_lik_kernel" in f.stats and "vag_calls" in f.stats]
    calls = sum(sum(f.stats["vag_calls"].values()) for f in fits)
    if not calls:
        return None
    return 100.0 * sum(f.stats["vag_calls_lik_kernel"] for f in fits) / calls
