"""Per-chain masked loops: the port's form of a vmapped ``lax.while_loop``.

Under ``vmap`` JAX runs a while-loop body while ANY chain's predicate
holds, and a finished chain keeps its old carry in every field. The
port's loops do the same: each iteration computes the body for the
whole batch and keeps the new value only where the chain's predicate
holds (``keep``). Deciding whether to run another iteration reads the
batch's predicate on the host, one device sync per iteration;
``HostSyncs`` counts them, and the run's value-and-grad calls.
"""

import torch

from exmc_tpu_torch.utils import profiling


class HostSyncs:
    """Counts one run's host syncs of the masked loops (``count``), the
    count when its first post-warmup iteration began (``warmup``; None
    until then), its value-and-grad calls by site (``vag_calls``;
    ``counted`` wraps a site's value-and-grad) and the tree's leaves that
    the leaf kernel ran (``leaf_kernel``)."""

    def __init__(self):
        self.count = 0
        self.warmup = None
        self.vag_calls = {}
        self.leaf_kernel = 0

    def any(self, mask) -> bool:
        """True if any chain is still active (one device -> host sync)."""
        return self._read(mask.any)

    def flag(self, flag) -> bool:
        """The one-element device tensor ``flag`` as a bool (one device ->
        host sync)."""
        return self._read(flag.item)

    def _read(self, read):
        self.count += 1
        if not profiling.TRACING:
            return bool(read())
        token = profiling.leaf_begin("exmc.sync")
        out = bool(read())
        profiling.leaf_end("exmc.sync", token)
        return out

    def counted(self, vag_fn, site):
        """``vag_fn``, each call counted in ``vag_calls[site]``."""
        self.vag_calls.setdefault(site, 0)

        def vag(*args, **kwargs):
            self.vag_calls[site] += 1
            return vag_fn(*args, **kwargs)

        return vag


def keep(active, new, old):
    """``new`` where the chain is active, else ``old``; ``active`` is (C,)
    and broadcasts over trailing axes."""
    a = active.reshape(active.shape + (1,) * (new.ndim - 1))
    return torch.where(a, new, old)
