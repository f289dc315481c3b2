"""Table sessions (``exmc_tpu/apps/poker/table.py``): a ``Table``
accumulates hand histories per player and profiles on demand; a
``MultiTable`` profiles every player of every table in one batched NUTS
run (``opponent_model.build_batched``). Seeds and generator consumption
are the JAX package's, so the histories are equal bit for bit."""

import numpy as np

from exmc_tpu_torch.apps.poker import api, simulator
from exmc_tpu_torch.apps.poker.action_model import sample_action


class Table:
    def __init__(self, player_params=None, seed=0):
        self.players = player_params or simulator.archetypes()
        self.rng = np.random.default_rng(seed)
        self.observations = [
            {"hand_strengths": [], "actions": []} for _ in self.players
        ]

    def play(self, hands=50):
        """Deal ``hands`` rounds; every player acts from their true
        parameters."""
        for _ in range(hands):
            for i, params in enumerate(self.players):
                hs = float(self.rng.random())
                act = sample_action(
                    self.rng, params["vpip"], params["pfr"], params["agg"],
                    params["bluff"], hs,
                )
                self.observations[i]["hand_strengths"].append(hs)
                self.observations[i]["actions"].append(act)
        return self

    def profile(self, **opts):
        """Bayesian profile of every seated player from the accumulated
        history."""
        return api.profile(self.observations, **opts)

    def hand_counts(self):
        return [len(o["actions"]) for o in self.observations]


class MultiTable:
    """Several tables, profiled together: per-table hyperparameters are
    (T,) vectors and the likelihood is one (T, P, H) log-softmax."""

    def __init__(self, table_params=None, num_tables=4, seed=0):
        if table_params is None:
            table_params = [simulator.archetypes()[:3] for _ in range(num_tables)]
        self.tables = [
            Table(params, seed=seed + 31 * i)
            for i, params in enumerate(table_params)
        ]

    def play(self, hands=50):
        for t in self.tables:
            t.play(hands)
        return self

    def profile_all(self, **opts):
        """One NUTS run profiling every player at every table. Returns
        (a list per table of lists per player of profiles, stats)."""
        return api.profile_tables([t.observations for t in self.tables], **opts)
