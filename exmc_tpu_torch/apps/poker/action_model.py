"""Action model (``exmc_tpu/apps/poker/action_model.py``): a softmax
over (fold, call, raise) given a player's parameters and hand strength.

``action_logits``, ``log_action_probs`` and ``gather_log_probs`` are
torch, broadcasting over any leading axes (chains, tables, players,
hands); ``action_probs`` and ``sample_action`` are the host-side numpy
versions for simulation and decisions, consuming the generator as the
JAX package's do."""

import numpy as np
import torch


def action_logits(vpip, pfr, agg, bluff, hs):
    """(..., 3) logits; the inputs broadcast together."""
    vpip = torch.clamp(vpip, -5.0, 5.0)
    pfr = torch.clamp(pfr, -5.0, 5.0)
    agg = torch.clamp(agg, 0.01, 10.0)
    bluff = torch.clamp(bluff, -5.0, 5.0)
    hs = torch.as_tensor(hs, dtype=vpip.dtype, device=vpip.device)
    fold_l = torch.zeros_like(hs)
    call_l = hs * 2.0 + vpip * 3.0 - 1.0
    raise_l = hs * 2.0 * agg + pfr * 3.0 + bluff * (1.0 - hs) * 3.0 - 1.5
    return torch.stack(torch.broadcast_tensors(fold_l, call_l, raise_l), dim=-1)


def log_action_probs(vpip, pfr, agg, bluff, hs):
    """Log-softmax of the logits over the last axis."""
    return torch.log_softmax(action_logits(vpip, pfr, agg, bluff, hs), dim=-1)


def gather_log_probs(log_probs, actions):
    """The observed actions' log-probabilities: ``log_probs`` (..., 3)
    at ``actions`` (0, 1 or 2, any dtype), broadcast against its leading
    axes. Equal to the JAX package's one-hot sum for finite log-probs."""
    idx = actions.long().expand(log_probs.shape[:-1])
    return torch.gather(log_probs, -1, idx.unsqueeze(-1)).squeeze(-1)


def action_probs(vpip, pfr, agg, bluff, hand_strength):
    """Host-side (fold, call, raise) probabilities."""
    fold_l = 0.0
    call_l = vpip * 3.0 + hand_strength * 2.0 - 1.0
    raise_l = (
        pfr * 3.0 + agg * hand_strength * 2.0
        + bluff * (1.0 - hand_strength) * 3.0 - 1.5
    )
    ls = np.array([fold_l, call_l, raise_l])
    e = np.exp(ls - ls.max())
    p = e / e.sum()
    return float(p[0]), float(p[1]), float(p[2])


def sample_action(rng, vpip, pfr, agg, bluff, hand_strength):
    """One action drawn with ``rng`` (one uniform)."""
    p_fold, p_call, _ = action_probs(vpip, pfr, agg, bluff, hand_strength)
    u = rng.random()
    if u < p_fold:
        return 0
    if u < p_fold + p_call:
        return 1
    return 2
