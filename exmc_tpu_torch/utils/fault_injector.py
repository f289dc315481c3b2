"""Deliberate numerical-fault injection (``exmc_tpu/utils/fault_injector.py``).

The sampler has no host tree to crash: the failure domain is numerical.
The NUTS leaf's divergence test (``~(delta >= -threshold)``) is NaN-safe,
so any NaN or Inf the log-density produces becomes a divergent leaf, the
trajectory ends, and the chain keeps running. The injector wraps a
compiled model's value-and-grad so that it returns NaN, -Inf or a
blown-up gradient at chosen points, letting tests check that recovery
end to end: faults become divergences and every chain reports finite
draws.
"""

import dataclasses
from dataclasses import dataclass

import torch


@dataclass
class FaultInjector:
    """Wraps ``vag_fn``-style callables with a fault region.

    kind: "nan" | "inf" | "huge_grad".
    trigger_lo, trigger_hi: a chain's fault fires when any coordinate of
    its q falls inside [trigger_lo, trigger_hi] (a spatial trigger: a
    step-count trigger has no meaning in a batched pipeline).
    """

    kind: str = "nan"
    trigger_lo: float = 0.0
    trigger_hi: float = 0.5

    def wrap(self, vag_fn):
        """``vag_fn((C, d), *args) -> ((C,), (C, d))`` with the fault on
        the chains whose q is in the region."""
        kind = self.kind
        lo, hi = self.trigger_lo, self.trigger_hi
        if kind not in ("nan", "inf", "huge_grad"):
            raise ValueError(f"unknown fault kind {kind!r}")

        def wrapped(q, *args):
            v, g = vag_fn(q, *args)
            hit = ((q >= lo) & (q <= hi)).any(dim=-1)
            if kind == "nan":
                v = torch.where(hit, torch.full_like(v, float("nan")), v)
            elif kind == "inf":
                v = torch.where(hit, torch.full_like(v, -float("inf")), v)
            else:
                g = torch.where(hit.unsqueeze(-1), g * 1e30, g)
            return v, g

        return wrapped

    def wrap_model(self, model):
        """A shallow copy of a ``CompiledModel`` with faulted logp and
        value_and_grad."""
        vag = self.wrap(model.value_and_grad)

        def logp(q, data=None):
            return vag(q, data)[0]

        return dataclasses.replace(model, logp=logp, value_and_grad=vag)
