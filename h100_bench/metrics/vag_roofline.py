"""The value-and-grad's share of its roofline: the least time the card
could take (the larger of its operations over the float32 peak and its
bytes over the memory bandwidth, both counted from shapes by the
configuration's ``vag_flops`` and ``vag_bytes``) over ``vag_ms``."""

from h100_bench import peaks


def read(run):
    flops = getattr(run.config, "vag_flops", None)
    nbytes = getattr(run.config, "vag_bytes", None)
    ms = run.value("vag_ms")
    if flops is None or nbytes is None or not ms:
        return None
    cfg = run.spec.cfg
    bound_s = max(flops(cfg, run.chains) / peaks.FLOAT32_FLOPS,
                  nbytes(cfg, run.chains) / peaks.HBM_BYTES_PER_S)
    return 100.0 * bound_s / (ms / 1000.0)
