"""Per-chain masked loops: the port's form of a vmapped ``lax.while_loop``.

Under ``vmap`` JAX runs a while-loop body while ANY chain's predicate
holds, and a finished chain keeps its old carry in every field. The
port's loops do the same: each iteration computes the body for the
whole batch and keeps the new value only where the chain's predicate
holds (``keep``). Deciding whether to run another iteration reads the
batch's predicate on the host, one device sync per iteration;
``HostSyncs`` counts them.
"""

import torch


class HostSyncs:
    """Counts the host syncs of the masked loops of one run."""

    def __init__(self):
        self.count = 0

    def any(self, mask) -> bool:
        """True if any chain is still active (one device -> host sync)."""
        self.count += 1
        return bool(mask.any())


def keep(active, new, old):
    """``new`` where the chain is active, else ``old``; ``active`` is (C,)
    and broadcasts over trailing axes."""
    a = active.reshape(active.shape + (1,) * (new.ndim - 1))
    return torch.where(a, new, old)
