"""The whole fit's share of the card's float32 peak: one batched
value-and-grad per host sync of the NUTS tree (the masked loop calls the
model once for all chains per leaf), its operations counted from shapes
by the configuration's ``vag_flops``, over the fits' seconds. Masked
chains' work counts as done until the program reports per-chain leaf
counts."""

from h100_bench import peaks


def read(run):
    flops = getattr(run.config, "vag_flops", None)
    fits = [f for f in run.fits if f.host_syncs]
    if flops is None or not fits or not str(run.device).startswith("cuda"):
        return None
    done = sum(f.host_syncs for f in fits) * flops(run.spec.cfg, run.chains)
    return 100.0 * done / (sum(f.seconds for f in fits) * peaks.FLOAT32_FLOPS)
