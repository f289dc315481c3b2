"""Per-chain masked loops: the port's form of a vmapped ``lax.while_loop``.

Under ``vmap`` JAX runs a while-loop body while ANY chain's predicate
holds, and a finished chain keeps its old carry in every field. The
port's loops do the same: each iteration computes the body for the
whole batch and keeps the new value only where the chain's predicate
holds (``keep``). Deciding whether to run another iteration reads the
batch's predicate on the host, one device sync per iteration;
``HostSyncs`` counts them, and holds every other count of a NUTS run.
"""

import numpy as np
import torch

from exmc_tpu_torch.utils import profiling

# where a NUTS run calls the model's value-and-grad (``HostSyncs.counted``
# counts each site's calls): the tree's leapfrog steps, the init search,
# the step-size search, the dead-chain recovery's fresh point, the
# ensemble rescue and the interweave step
VAG_SITES = ("leaf", "init", "eps_search", "recovery", "rescue", "interweave")

# the keys of a NUTS run's stats that hold the run's counts rather than
# per-chain arrays (``HostSyncs.stat_keys`` adds the model's counters)
RUN_COUNTS = ("host_syncs", "vag_calls", "vag_calls_lik_kernel", "leaf_kernel_leaves")


class HostSyncs:
    """The one record of a run's counts: its host syncs (``count``), the
    count when its first post-warmup iteration began (``warmup``; None
    until then), its value-and-grad calls by site (``vag_calls``), the
    tree's leaves that the leaf kernel ran (``leaf_kernel``) and a
    model's device ``counters`` (a Laplace marginal's), reset when the
    record is made. ``lik_kernel``: the run's value-and-grad holds the
    Bernoulli-logit GLM kernel. A new count goes here and at the site
    that increments it."""

    def __init__(self, lik_kernel=False, counters=()):
        self.count = 0
        self.warmup = None
        self.vag_calls = {}
        self.leaf_kernel = 0
        self.lik_kernel = lik_kernel
        self.counters = tuple(counters)
        for c in self.counters:
            c.reset()

    def any(self, mask) -> bool:
        """True if any chain is still active (one device -> host sync)."""
        return self.read(lambda: bool(mask.any()))

    def flag(self, flag) -> bool:
        """The one-element device tensor ``flag`` as a bool (one device ->
        host sync)."""
        return self.read(lambda: bool(flag.item()))

    def read(self, read):
        """``read()``, which waits on the device, as one counted host sync,
        in an ``exmc.sync`` span with tracing on."""
        self.count += 1
        if not profiling.TRACING:
            return read()
        token = profiling.leaf_begin("exmc.sync")
        out = read()
        profiling.leaf_end("exmc.sync", token)
        return out

    def counted(self, vag_fn, site):
        """``vag_fn``, each call counted in ``vag_calls[site]``."""
        self.vag_calls.setdefault(site, 0)

        def vag(*args, **kwargs):
            self.vag_calls[site] += 1
            return vag_fn(*args, **kwargs)

        return vag

    def report(self):
        """A NUTS run's ``last_run`` counts (``host_syncs_warmup``: before
        its first post-warmup iteration, the init search included)."""
        calls = {site: self.vag_calls.get(site, 0) for site in VAG_SITES}
        return {"host_syncs": self.count,
                "host_syncs_warmup": self.count if self.warmup is None else self.warmup,
                "vag_calls": calls,
                "vag_calls_lik_kernel": sum(calls.values()) if self.lik_kernel else 0,
                "leaf_kernel_leaves": self.leaf_kernel}

    @staticmethod
    def stat_keys(counters=()):
        """The keys of ``stats()`` for a model with ``counters``."""
        return RUN_COUNTS + tuple(dict.fromkeys(c.name for c in counters))

    def stats(self):
        """A NUTS run's stats counts: ``RUN_COUNTS``, and each counter's
        ``read()`` under its name, counters of one name merged."""
        report = self.report()
        out = {k: report[k] for k in RUN_COUNTS}
        for name in self.stat_keys(self.counters)[len(RUN_COUNTS):]:
            group = [c for c in self.counters if c.name == name]
            out[name] = group[0].read(*group[1:])
        return out

    def payload(self):
        """The counts for a chunked run's .npz checkpoint (the model's
        counters restart at a resume)."""
        out = {"host_syncs": np.asarray(self.count),
               "host_syncs_warmup": np.asarray(-1 if self.warmup is None else self.warmup)}
        for k in VAG_SITES:
            out[f"vag_calls.{k}"] = np.asarray(self.vag_calls.get(k, 0))
        out["leaf_kernel_leaves"] = np.asarray(self.leaf_kernel)
        return out

    def restore(self, arrays):
        """The counts of ``payload()``; one that an older checkpoint lacks
        starts here (warmup's syncs: at the next post-warmup iteration)."""
        self.count = int(arrays["host_syncs"])
        warmup = int(arrays.get("host_syncs_warmup", -1))
        self.warmup = None if warmup < 0 else warmup
        self.vag_calls = {k: int(arrays.get(f"vag_calls.{k}", 0)) for k in VAG_SITES}
        self.leaf_kernel = int(arrays.get("leaf_kernel_leaves", 0))


def keep(active, new, old):
    """``new`` where the chain is active, else ``old``; ``active`` is (C,)
    and broadcasts over trailing axes."""
    a = active.reshape(active.shape + (1,) * (new.ndim - 1))
    return torch.where(a, new, old)
