"""Table simulator (``exmc_tpu/apps/poker/simulator.py``, in numpy)."""

import numpy as np

from exmc_tpu_torch.apps.poker.action_model import sample_action

ARCHETYPES = [
    {"vpip": 0.22, "pfr": 0.18, "agg": 1.8, "bluff": 0.25, "label": "tag"},
    {"vpip": 0.35, "pfr": 0.28, "agg": 2.2, "bluff": 0.40, "label": "lag"},
    {"vpip": 0.12, "pfr": 0.10, "agg": 1.2, "bluff": 0.10, "label": "nit"},
    {"vpip": 0.45, "pfr": 0.08, "agg": 0.5, "bluff": 0.05, "label": "station"},
    {"vpip": 0.50, "pfr": 0.40, "agg": 3.0, "bluff": 0.55, "label": "maniac"},
]


def archetypes():
    """The five canonical player types."""
    return [dict(a) for a in ARCHETYPES]


def simulate(player_params, hands=50, seed=0):
    """Simulate each player's actions over ``hands`` uniform-strength
    hands. Returns (observations, true_params)."""
    rng = np.random.default_rng(seed)
    observations = []
    for params in player_params:
        hs = rng.random(hands)
        acts = [
            sample_action(rng, params["vpip"], params["pfr"], params["agg"],
                          params["bluff"], h)
            for h in hs
        ]
        observations.append({"hand_strengths": hs.tolist(), "actions": acts})
    return observations, player_params
