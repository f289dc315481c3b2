"""Decision EV under posterior uncertainty
(``exmc_tpu/apps/poker/decision.py``, in numpy), over the posterior
draws."""

import numpy as np

from exmc_tpu_torch.apps.poker import cards
from exmc_tpu_torch.apps.poker.action_model import action_probs


def expected_value(my_hole, board, profile, pot, to_call, *, raise_to=None,
                   equity_samples=200):
    raise_to = pot if raise_to is None else raise_to
    equity = cards.hand_strength(my_hole, board, equity_samples)

    vpip = np.asarray(profile["vpip"])
    pfr = np.asarray(profile["pfr"])
    agg = np.asarray(profile["agg"])
    bluff = np.asarray(profile["bluff"])
    n = vpip.shape[0]

    ev_call_each = np.full(n, equity * (pot + to_call) - to_call)

    # the opponent's fold probability facing our raise at median strength 0.5
    raise_evs = np.empty(n)
    for i in range(n):
        p_fold, _, _ = action_probs(vpip[i], pfr[i], agg[i], bluff[i], 0.5)
        total_pot = pot + 2 * raise_to
        ev_they_fold = pot
        ev_they_call = equity * total_pot - raise_to
        raise_evs[i] = p_fold * ev_they_fold + (1 - p_fold) * ev_they_call

    ev_fold = 0.0
    ev_call = float(ev_call_each.mean())
    ev_raise = float(raise_evs.mean())
    rec = (
        "raise" if ev_raise >= ev_call and ev_raise >= ev_fold
        else ("call" if ev_call >= ev_fold else "fold")
    )
    return {
        "fold": ev_fold,
        "call": ev_call,
        "raise": ev_raise,
        "equity": equity,
        "p_call_positive": float((ev_call_each > 0).mean()),
        "p_raise_positive": float((raise_evs > 0).mean()),
        "recommended": rec,
    }


def format_decision(d):
    return (
        f"equity={d['equity']:.2f} EV(fold)=0 EV(call)={d['call']:.1f} "
        f"EV(raise)={d['raise']:.1f} -> {d['recommended'].upper()}"
    )
