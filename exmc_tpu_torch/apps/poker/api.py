"""Top-level poker API (``exmc_tpu/apps/poker/api.py``). ``profile`` and
``profile_tables`` run the port's NUTS on ``device`` (an option passed
through ``**opts``, default ``"cuda"``)."""

import numpy as np

from exmc_tpu_torch.apps.poker import cards, decision, opponent_model, simulator


def simulate(players=None, hands=50, seed=0):
    """Simulate a table."""
    if players is None:
        players = simulator.archetypes()[:3]
    return simulator.simulate(players, hands, seed=seed)


def profile(observations, num_samples=300, num_warmup=300, seed=42, **opts):
    """Profile opponents by NUTS. Returns (profiles, stats)."""
    from exmc_tpu_torch.nuts.sampler import sample

    ir = opponent_model.build(observations)
    trace, stats = sample(ir, num_warmup=num_warmup, num_samples=num_samples,
                          seed=seed, ncp=False, **opts)
    profiles = opponent_model.extract_profiles(trace, len(observations))
    return profiles, stats


def profile_tables(tables, num_samples=300, num_warmup=300, seed=42, **opts):
    """Profile many tables together in one batched NUTS run.
    ``tables``: a list of per-table observation lists. Returns (profiles
    per table per player, stats)."""
    from exmc_tpu_torch.nuts.sampler import sample

    ir = opponent_model.build_batched(tables)
    trace, stats = sample(ir, num_warmup=num_warmup, num_samples=num_samples,
                          seed=seed, ncp=False, **opts)
    profiles = opponent_model.extract_profiles_batched(
        trace, [len(obs) for obs in tables])
    return profiles, stats


def decide(my_hole, board, opponent, pot, to_call, **opts):
    """EV-based decision."""
    hole = [cards.parse(c) for c in my_hole]
    brd = [cards.parse(c) for c in board]
    return decision.expected_value(hole, brd, opponent, pot, to_call, **opts)


def compare(true_params, profiles):
    """True-against-inferred comparison table."""
    out = []
    for i, (true_p, prof) in enumerate(zip(true_params, profiles)):
        out.append({
            "player": true_p.get("label", f"player_{i}"),
            "true": {k: true_p[k] for k in ("vpip", "pfr", "agg", "bluff")},
            "posterior_mean": {
                k: round(float(np.mean(prof[k])), 3)
                for k in ("vpip", "pfr", "agg", "bluff")
            },
        })
    return out
