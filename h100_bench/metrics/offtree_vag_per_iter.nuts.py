"""Value-and-grad calls outside the NUTS tree per iteration (warmup and
draws), over the window's fits: the init search, the step-size search,
the dead-chain recovery's fresh point, the ensemble rescue and the
interweave step (``stats["vag_calls"]`` less its ``leaf`` calls), each a
batched call over all chains that ``syncs_per_iter.nuts`` does not
count."""


def read(run):
    fits = [f for f in run.fits if "vag_calls" in f.stats and f.iterations]
    if not fits:
        return None
    calls = sum(n for f in fits for site, n in f.stats["vag_calls"].items() if site != "leaf")
    return calls / sum(f.iterations for f in fits)
