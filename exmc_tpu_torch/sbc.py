"""Simulation-based calibration (``exmc_tpu/sbc.py``; Talts et al. 2018,
Modrak et al. 2022 for the ECDF view).

Per replication r: theta_r ~ prior, y_r ~ likelihood(theta_r), a
posterior run on y_r, and the rank of theta_r among the L thinned draws.
If the pipeline (IR, rewrites, transforms, sampler, constraining) is
right, the ranks are uniform on {0..L}.

The JAX package vmaps the sampler over replications with the data as a
dict-valued ``__obs_data`` argument. The port runs the R replications
as ONE batch of chains whose data leaves carry a leading axis of R (or
R * M) rows instead of 1 (``_replication_data``): every observation's
value becomes a keyed data ref (``_data_arg_ir``), and chain i reads row
i. The model's own ``Builder.data`` stays at a leading axis of 1 under
``"__base"`` and broadcasts. NUTS runs one chain per replication with
per-chain adaptation (``pooled_adaptation=False,
ensemble_rescue=False``); ChEES/SNAPER and MEADS run R groups of
``chees_chains`` chains whose cross-chain adaptation stays inside each
group (``chees.run_groups``, ``meads.run_groups``). Ranks are taken in
the constrained space, draw r's constraining paired with data row r.

``rep_batch=B`` runs the replications in batches of B chains (padded by
wrapping to one shape). The port's draws depend on the batch (the
masked tree loop runs as long as the batch's deepest tree), so
``rep_batch >= R`` equals ``rep_batch=None`` bit for bit, and a smaller
batch gives other draws of the same calibration.
"""

from dataclasses import replace

import numpy as np
import torch
from scipy.special import gammaincc

from exmc_tpu_torch.compiler import (
    OBS_DATA_KEY,
    DeviceData,
    _const,
    compile_logp,
    constrainer,
)
from exmc_tpu_torch.config import default_dtype, prepare_device
from exmc_tpu_torch.predictive import posterior_predictive, prior_samples

ENSEMBLE_FOLDS = 4
BATCH_SEED_STRIDE = 1000


def _obs_nodes(ir):
    """All obs and meas_obs nodes; an interval-censored one cannot carry
    simulated values and is refused."""
    nodes = [(nid, n) for nid, n in sorted(ir.nodes.items())
             if n.op[0] in ("obs", "meas_obs")]
    if not nodes:
        raise ValueError("sbc: model has no observation nodes")
    for nid, n in nodes:
        if isinstance(n.op[2], dict):
            raise ValueError(
                f"sbc: obs node {nid!r} is interval-censored — the "
                "synthetic-data channel carries simulated values, not "
                "censoring intervals")
    return nodes


def _data_arg_ir(ir, obs_nodes):
    """Every obs node's value rewritten to a keyed ``("__obs_data",
    obs_id)`` ref; the IR's data becomes {obs_id: value}, plus the
    model's own ``Builder.data`` under ``"__base"``, which plain
    ``"__obs_data"`` refs keep reading."""
    ir2, data = ir, {}
    for obs_id, node in obs_nodes:
        value = node.op[2]
        if isinstance(value, str) and value == OBS_DATA_KEY:
            if ir.data is None:
                raise ValueError(f"sbc: obs node {obs_id!r} references __obs_data "
                                 "but the IR carries no data")
            data[obs_id] = np.asarray(ir.data)
        else:
            data[obs_id] = np.asarray(value)
        ir2 = ir2.replace_node(replace(
            node, op=node.op[:2] + ((OBS_DATA_KEY, obs_id),) + node.op[3:]))
    if ir.data is not None:
        data["__base"] = ir.data
    return replace(ir2, data=data)


def _chi2_sf(stat, dof):
    """Survival function of chi^2_dof (the regularized upper incomplete
    gamma), as a float32 like the JAX package's."""
    return float(np.float32(gammaincc(dof / 2.0, stat / 2.0)))


def rank_uniformity(ranks, L, num_bins=20):
    """Chi-squared uniformity test of SBC ranks on {0..L}: (statistic,
    p_value). At most ``num_bins`` equal-width bins (and R // 5); each
    bin's expected count follows the number of integer ranks it holds,
    not its width."""
    ranks = np.asarray(ranks)
    R = ranks.shape[0]
    B = int(max(2, min(num_bins, L + 1, R // 5)))
    edges = np.linspace(0, L + 1, B + 1)
    counts, _ = np.histogram(ranks, bins=edges)
    sup_counts, _ = np.histogram(np.arange(L + 1), bins=edges)
    expected = R * sup_counts / (L + 1.0)
    stat = float(((counts - expected) ** 2 / expected).sum())
    return stat, _chi2_sf(stat, B - 1)


def ecdf_ks(ranks, L, num_sims=2000, seed=0):
    """Kolmogorov-style test of the ranks against the discrete uniform,
    the null simulated exactly: (max_t |ECDF(t) - (t+1)/(L+1)|, p)."""
    ranks = np.asarray(ranks)
    R = ranks.shape[0]
    grid = np.arange(L + 1)
    uniform_cdf = (grid + 1) / (L + 1)

    def stat(r):
        ecdf = np.searchsorted(np.sort(r), grid, side="right") / R
        return np.abs(ecdf - uniform_cdf).max()

    observed = stat(ranks)
    rng = np.random.default_rng(seed)
    sims = rng.integers(0, L + 1, size=(num_sims, R))
    null = np.array([stat(s) for s in sims])
    return float(observed), float((null >= observed).mean())


def _replication_data(y_rows, base, device, repeat=1):
    """A ``DeviceData`` whose obs leaves carry one row per chain: each
    replication's simulated values (R, ...) repeated ``repeat`` times
    (consecutive chains of a group); ``"__base"`` keeps its axis of 1."""
    value = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
             .repeat_interleave(repeat, dim=0) for k, v in y_rows.items()}
    if base is not None:
        value["__base"] = _const(base, device)
    return DeviceData(value)


def _rows(ddata, repeat):
    """``ddata`` with every leaf of more than one row repeated row by row
    ``repeat`` times (pairing draws with their replication's data)."""
    return DeviceData({k: (v.repeat_interleave(repeat, dim=0) if v.ndim and v.shape[0] > 1
                           else v) for k, v in ddata.value.items()})


def _constrain_rows(model, ddata, draws):
    """(B, L, d) draws of B chains -> {name: (B, L, *shape)} constrained,
    draw (b, l) read against data row b."""
    b, n, d = draws.shape
    named = constrainer(model.ir, model.pm, model.device, _rows(ddata, n))(
        draws.reshape(b * n, d))
    return {k: v.reshape((b, n) + tuple(v.shape[1:])) for k, v in named.items()}


def _batches(r, rep_batch):
    """(start, end, padded indices) of each batch of replications."""
    if not rep_batch or rep_batch >= r:
        return [(0, r, np.arange(r))]
    return [(s, min(s + rep_batch, r), s + np.arange(rep_batch) % (min(s + rep_batch, r) - s))
            for s in range(0, r, rep_batch)]


def sbc(ir, *, num_replications=200, num_warmup=500, num_samples=1000, thin=10,
        seed=0, ncp=True, num_bins=20, engine="nuts", chees_chains=8,
        rep_batch=None, device=None, **sampler_opts):
    """Run SBC for ``ir`` on ``device`` (default ``"cuda"``). Returns
    {"ranks": {component: (R,) ranks in [0, L]}, "L", "num_replications",
    "chi2" and "ecdf": {component: (statistic, p)}, "min_p",
    "min_ecdf_p", "divergence_rate", "host_syncs"}.

    ``engine``: "nuts" (one chain per replication), "chees" / "snaper"
    (``chees_chains`` chains per replication, ranks pooled over them, so
    L = chees_chains * num_samples / thin) or "meads" (``chees_chains``
    chains in 4 folds per replication, started at the replication's true
    theta plus 0.01 noise). ``rep_batch`` bounds the replications of one
    batch; sampler options go to the NUTS sampler only."""
    if engine not in ("nuts", "chees", "snaper", "meads"):
        raise ValueError(f"unknown engine {engine!r} (nuts|chees|snaper|meads)")
    if engine in ("chees", "snaper", "meads"):
        if sampler_opts:
            raise TypeError(f"engine={engine!r} takes no sampler options, got "
                            f"{sorted(sampler_opts)}")
        if chees_chains < 2:
            raise ValueError("chees_chains must be >= 2 (the ChEES criterion is "
                             "cross-chain; 1 chain degenerates to fixed-T HMC)")
    if engine == "meads" and (chees_chains % ENSEMBLE_FOLDS != 0
                              or chees_chains // ENSEMBLE_FOLDS < 2):
        raise ValueError(
            f"engine='meads' needs chees_chains divisible by {ENSEMBLE_FOLDS} folds "
            f"with >= 2 chains per fold (got {chees_chains})")
    dev = prepare_device(device)
    R = num_replications
    obs_nodes = _obs_nodes(ir)
    model0 = compile_logp(ir, ncp=ncp, device=dev)
    names = [e.id for e in model0.pm.entries]

    # theta ~ prior, then y | theta through the posterior predictive of a
    # (1, R) "trace" of the prior draws
    prior = prior_samples(ir, num_draws=R, seed=seed, device=dev)
    theta_true = {k: prior[k] for k in names}
    y = posterior_predictive(model0, {k: prior[k][None] for k in names},
                             seed=seed + 1)
    y_rows = {obs_id: y[obs_id][0] for obs_id, _ in obs_nodes}
    ir2 = _data_arg_ir(ir, obs_nodes)
    base = ir2.data.get("__base")
    m = 1 if engine == "nuts" else chees_chains

    if engine == "nuts":
        from exmc_tpu_torch.nuts.sampler import _make_sampler

        sampler = _make_sampler(ir2, ncp=ncp, device=dev, num_warmup=num_warmup,
                                num_samples=num_samples, ensemble_rescue=False,
                                pooled_adaptation=False, **sampler_opts)
        model2 = sampler.model
    else:
        model2 = compile_logp(ir2, ncp=ncp, device=dev)

    named_parts, div, syncs = [], 0, 0
    for b, (s, e, idx) in enumerate(_batches(R, rep_batch)):
        rows = {k: v[idx] for k, v in y_rows.items()}
        bseed = seed + 2 + BATCH_SEED_STRIDE * b
        ddata = _replication_data(rows, base, dev, repeat=m)
        if engine == "nuts":
            draws, stats = sampler.run(num_chains=len(idx), seed=bseed, data=ddata,
                                       return_unconstrained=True)
            syncs += sampler.last_run["host_syncs"]
            draws = torch.as_tensor(draws, device=dev)
            diverging = stats["diverging"]
        elif engine in ("chees", "snaper"):
            from exmc_tpu_torch import chees

            outs, _, n_sync = chees.run_groups(model2, ddata, len(idx), m, num_warmup,
                                               num_samples, bseed, criterion=engine)
            syncs += n_sync
            draws, diverging = outs["q"], outs["diverging"].cpu().numpy()
        else:
            from exmc_tpu_torch import meads

            flat0 = model2.unconstrain_batch({k: theta_true[k][idx] for k in names})
            gen = torch.Generator(device=dev)
            gen.manual_seed(bseed + meads.MOMENTUM_SEED_OFFSET + 5)
            q_inits = flat0.to(default_dtype()).repeat_interleave(m, 0) + 0.01 * torch.randn(
                len(idx) * m, model2.size, generator=gen, dtype=default_dtype(), device=dev)
            fold_data = _replication_data(rows, base, dev, repeat=m // ENSEMBLE_FOLDS)
            outs, _, _, _ = meads.run_groups(model2, ddata, fold_data, q_inits, len(idx),
                                             ENSEMBLE_FOLDS, num_warmup, num_samples, bseed)
            draws, diverging = outs["q"], outs["diverging"].cpu().numpy()
        # (chains, samples, d) -> each replication's thinned draws
        sub = draws[:, thin - 1::thin]
        n_keep = e - s
        sub = sub.reshape((len(idx), m * sub.shape[1]) + tuple(sub.shape[2:]))[:n_keep]
        rep_data = _replication_data({k: v[:n_keep] for k, v in rows.items()}, base, dev)
        named = _constrain_rows(model2, rep_data, sub)
        named_parts.append({k: v.cpu().numpy() for k, v in named.items()})
        div += int(np.asarray(diverging).reshape(len(idx), -1)[:n_keep].sum())
    named = {k: np.concatenate([p[k] for p in named_parts]) for k in names}
    L = int(named[names[0]].shape[1])

    ranks, chi2, ecdf = {}, {}, {}
    for k in names:
        draws_k = named[k].reshape(R, L, -1)
        true_k = np.asarray(theta_true[k]).reshape(R, -1)
        r_k = (draws_k < true_k[:, None, :]).sum(axis=1)
        for c in range(draws_k.shape[-1]):
            if np.ptp(draws_k[:, :, c]) == 0 and np.ptp(true_k[:, c]) == 0:
                # a structurally constant component (a Cholesky factor's
                # upper zeros): its rank carries no calibration signal
                continue
            name = k if draws_k.shape[-1] == 1 else f"{k}[{c}]"
            ranks[name] = r_k[:, c]
            chi2[name] = rank_uniformity(r_k[:, c], L, num_bins)
            ecdf[name] = ecdf_ks(r_k[:, c], L, seed=seed + 3)
    return {
        "ranks": ranks,
        "L": L,
        "num_replications": R,
        "chi2": chi2,
        "ecdf": ecdf,
        "min_p": min(p for _, p in chi2.values()),
        "min_ecdf_p": min(p for _, p in ecdf.values()),
        "divergence_rate": div / (R * num_samples * m),
        "host_syncs": syncs,
    }
