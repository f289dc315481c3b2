"""Hierarchical opponent model (``exmc_tpu/apps/poker/opponent_model.py``).

Population hyperparameters (logit scale for vpip, pfr and bluff, log
scale for agg) and per-player raws, partially pooled by a manual
non-centred reconstruction, under a softmax action likelihood: one
(C, P, H, 3) log-softmax for a table, one (C, T, P, H, 3) for T tables
(``build_batched``).

The likelihood is a ``Custom(..., align=False)``: it gets every
parameter with its chain axis and no inserted unit axes, and indexes
per-table hyperparameters as ``[..., None]`` where the JAX code writes
``[:, None]`` for one point. (The compiler's alignment would give a
(C, T) hyperparameter as (C, 1, T) against the (C, T, P) raws: a wrong
broadcast, and a silent one when T == P.) The observations are closed
over as constants, made on the device once (``math.const_like``).
``extract_profiles`` and ``extract_profiles_batched`` are numpy, as in
the JAX package."""

import numpy as np
import torch

from exmc_tpu_torch import dists
from exmc_tpu_torch.apps.poker.action_model import gather_log_probs, log_action_probs
from exmc_tpu_torch.ir import Builder
from exmc_tpu_torch.math import const_like

PARAMS = ("vpip", "pfr", "agg", "bluff")
HYPER_PRIORS = {  # (mu prior mean, mu prior sd)
    "vpip": (-0.85, 0.5),
    "pfr": (-1.4, 0.5),
    "agg": (0.0, 0.5),
    "bluff": (-1.4, 0.5),
}


def _pack(observations):
    """(hs, acts, mask), each (P, H) float32, zero-padded to the longest
    history."""
    num_players = len(observations)
    h = max(len(o["hand_strengths"]) for o in observations)
    hs = np.zeros((num_players, h), np.float32)
    acts = np.zeros((num_players, h), np.float32)
    mask = np.zeros((num_players, h), np.float32)
    for i, o in enumerate(observations):
        n = len(o["hand_strengths"])
        hs[i, :n] = o["hand_strengths"]
        acts[i, :n] = o["actions"]
        mask[i, :n] = 1.0
    return hs, acts, mask


def _likelihood(hs, acts, mask):
    """The action log-likelihood over (C, *B) reconstructed parameters,
    B = (P,) or (T, P), against (*B, H) observations; returns (C,)."""
    hs_of, acts_of, mask_of = const_like(hs), const_like(acts), const_like(mask)

    def likelihood(_x, params, data=None):
        def recon(prm):
            mu, sigma = params[f"mu_{prm}"], params[f"sigma_{prm}"]
            return mu[..., None] + sigma[..., None] * params[f"{prm}_raw"]

        vpip = torch.clamp(recon("vpip"), -10.0, 10.0)
        pfr = torch.clamp(recon("pfr"), -10.0, 10.0)
        agg = torch.exp(torch.clamp(recon("agg"), -3.0, 3.0))
        bluff = torch.clamp(recon("bluff"), -10.0, 10.0)
        lp = log_action_probs(
            torch.reciprocal(1.0 + torch.exp(-vpip))[..., None],
            torch.reciprocal(1.0 + torch.exp(-pfr))[..., None],
            agg[..., None],
            torch.reciprocal(1.0 + torch.exp(-bluff))[..., None],
            hs_of(vpip),
        )
        sel = gather_log_probs(lp, acts_of(vpip))
        return torch.sum((sel * mask_of(vpip)).flatten(1), dim=1)

    return dists.Custom(logpdf_fn=likelihood, support="real", align=False)


def _with_likelihood(ir, lik):
    refs = {}
    for prm in PARAMS:
        for name in (f"mu_{prm}", f"sigma_{prm}", f"{prm}_raw"):
            refs[name] = name
    ir = Builder.rv(ir, "likelihood", lik, refs)
    return Builder.obs(ir, "likelihood_obs", "likelihood", 0.0)


def build(observations):
    """The IR of one table. ``observations``: a list of
    {"hand_strengths": [float], "actions": [0|1|2]} per player."""
    hs, acts, mask = _pack(observations)
    num_players = hs.shape[0]
    ir = Builder.new_ir()
    for p in PARAMS:
        m0, s0 = HYPER_PRIORS[p]
        ir = Builder.rv(ir, f"mu_{p}", dists.Normal, {"mu": m0, "sigma": s0})
        ir = Builder.rv(ir, f"sigma_{p}", dists.HalfCauchy, {"scale": 0.5},
                        transform="log")
        ir = Builder.rv(ir, f"{p}_raw", dists.Normal,
                        {"mu": 0.0, "sigma": 1.0}, shape=(num_players,))
    return _with_likelihood(ir, _likelihood(hs, acts, mask))


def build_batched(tables):
    """The IR of T tables profiled together in one NUTS run: per-table
    hyperparameters are (T,) vectors, per-player raws (T, P), and the
    likelihood is one (T, P, H) log-softmax per chain.

    ``tables``: a list of per-table observation lists. Tables may have
    different player and hand counts (mask-padded)."""
    t = len(tables)
    p = max(len(obs) for obs in tables)
    h = max(max(len(o["hand_strengths"]) for o in obs) for obs in tables)
    hs = np.zeros((t, p, h), np.float32)
    acts = np.zeros((t, p, h), np.float32)
    mask = np.zeros((t, p, h), np.float32)
    for ti, obs in enumerate(tables):
        ths, tacts, tmask = _pack(obs)
        hs[ti, :ths.shape[0], :ths.shape[1]] = ths
        acts[ti, :ths.shape[0], :ths.shape[1]] = tacts
        mask[ti, :ths.shape[0], :ths.shape[1]] = tmask

    ir = Builder.new_ir()
    for prm in PARAMS:
        m0, s0 = HYPER_PRIORS[prm]
        ir = Builder.rv(ir, f"mu_{prm}", dists.Normal,
                        {"mu": m0, "sigma": s0}, shape=(t,))
        ir = Builder.rv(ir, f"sigma_{prm}", dists.HalfCauchy,
                        {"scale": 0.5}, transform="log", shape=(t,))
        ir = Builder.rv(ir, f"{prm}_raw", dists.Normal,
                        {"mu": 0.0, "sigma": 1.0}, shape=(t, p))
    return _with_likelihood(ir, _likelihood(hs, acts, mask))


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.clip(x, -10, 10)))


def _constrained(trace):
    """vpip, pfr, agg and bluff of every player from a trace."""
    def recon(prm):
        mu = trace[f"mu_{prm}"]            # (chains, draws[, T])
        sigma = trace[f"sigma_{prm}"]
        raw = trace[f"{prm}_raw"]          # (chains, draws[, T], P)
        return mu[..., None] + sigma[..., None] * raw

    return (_sigmoid(recon("vpip")), _sigmoid(recon("pfr")),
            np.exp(np.clip(recon("agg"), -3, 3)), _sigmoid(recon("bluff")))


def extract_profiles_batched(trace, table_sizes):
    """Per-table, per-player posterior parameters from a batched-model
    trace: a list (per table) of lists (per player) of dicts of (draws,)
    arrays."""
    vpip, pfr, agg, bluff = _constrained(trace)
    return [
        [
            {
                "vpip": vpip[..., ti, i].reshape(-1),
                "pfr": pfr[..., ti, i].reshape(-1),
                "agg": agg[..., ti, i].reshape(-1),
                "bluff": bluff[..., ti, i].reshape(-1),
            }
            for i in range(np_players)
        ]
        for ti, np_players in enumerate(table_sizes)
    ]


def extract_profiles(trace, num_players):
    """Posterior per-player constrained parameters: a list of dicts of
    (draws,) arrays, vpip, pfr and bluff in (0, 1), agg > 0."""
    vpip, pfr, agg, bluff = _constrained(trace)
    return [
        {
            "vpip": vpip[..., i].reshape(-1),
            "pfr": pfr[..., i].reshape(-1),
            "agg": agg[..., i].reshape(-1),
            "bluff": bluff[..., i].reshape(-1),
        }
        for i in range(num_players)
    ]
