"""Bayesian poker opponent profiling (``exmc_tpu/apps/poker``).

Hierarchical opponent modelling by NUTS: population hyperparameters and
partially pooled per-player parameters under a softmax action
likelihood. The per-player raws are four (P,)-vector RVs, and the
likelihood is one (P, H, 3) log-softmax over the whole table (one
(T, P, H, 3) over T tables in ``profile_tables``)."""

from exmc_tpu_torch.apps.poker import cards
from exmc_tpu_torch.apps.poker.api import compare, decide, profile, profile_tables, simulate
from exmc_tpu_torch.apps.poker.simulator import archetypes
from exmc_tpu_torch.apps.poker.table import MultiTable, Table

__all__ = ["simulate", "profile", "decide", "compare", "cards", "archetypes",
           "Table", "MultiTable", "profile_tables"]
