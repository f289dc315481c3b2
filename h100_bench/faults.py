"""Faults planted in the program for a run, in memory only, to show that
the comparison catches them: ``calibrate.py`` reads them on the card at
the cell's size, the tests on the CPU at a small one. The benchmark's
own runs plant none.

- ``stuck``: every NUTS transition returns its state unchanged;
- ``half_batch``: the likelihood leaves out half of the observations
  (the second half of each observed array, or every other observed
  node where each holds one value) and doubles the rest;
- ``altered``: each draw the run returns is the one made an iteration
  earlier, beside the log-density of its own iteration.

The exchange between chips is not a fault a one-chip cell can have.
"""

import contextlib

FAULTS = ("stuck", "half_batch", "altered")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def planted(fault):
    """Plant ``fault`` (one of FAULTS, or None) for the block."""
    if fault is None:
        yield
        return
    import torch

    from exmc_tpu_torch import compiler
    from exmc_tpu_torch.nuts import sampler

    if fault == "stuck":
        transition = sampler.nuts_transition

        def stuck(vag_fn, metric, eps, q, logp, grad, *args, **kw):
            _, _, _, st = transition(vag_fn, metric, eps, q, logp, grad, *args, **kw)
            return q, logp, grad, st

        with _patched(sampler, "nuts_transition", stuck):
            yield
    elif fault == "half_batch":
        obs_term = compiler._Graph.obs_term

        def half(self, node, val, data, reduce=True):
            term = obs_term(self, node, val, data, reduce=False)
            if term.ndim >= 2 and term.shape[-1] > 1:
                kept = 2.0 * term[..., :term.shape[-1] // 2]
                return kept.sum(-1) if reduce else kept
            ids = sorted(n for n, v in self.ir.nodes.items() if v.op[0] == "obs")
            return term * (2.0 if ids.index(node.id) % 2 == 0 else 0.0)

        with _patched(compiler._Graph, "obs_term", half):
            yield
    elif fault == "altered":
        finish = sampler.NUTSSampler._finish

        def altered(self, carry, draws, st, *args):
            return finish(self, carry, torch.roll(draws, 1, dims=1), st, *args)

        with _patched(sampler.NUTSSampler, "_finish", altered):
            yield
    else:
        raise ValueError(f"unknown fault {fault!r} (one of {FAULTS})")
