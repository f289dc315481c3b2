"""Trace containers / export helpers of the port
(``exmc_tpu/trace_utils.py``).

``to_inference_dict`` reshapes (trace, stats) into the ArviZ
InferenceData group convention (posterior + sample_stats with standard
stat names), so users migrating from the reference or PyMC can plug the
output into their existing diagnostics tooling; if ``arviz`` is
importable an actual ``InferenceData`` is returned."""

import numpy as np

# stat name -> arviz sample_stats convention
_STAT_RENAME = {
    "diverging": "diverging",
    "energy": "energy",
    "depth": "tree_depth",
    "n_steps": "n_steps",
    "accept_prob": "acceptance_rate",
    "logp": "lp",
    "step_size": "step_size",
}


def to_inference_dict(trace, stats=None):
    """Return {"posterior": {...}, "sample_stats": {...}} with
    (chain, draw, *shape) arrays; or an arviz.InferenceData when arviz
    is installed."""
    posterior = {k: np.asarray(v) for k, v in trace.items()}
    sample_stats = {}
    n_draws = None
    for v in posterior.values():
        n_draws = v.shape[1]
        break
    if stats:
        for k, name in _STAT_RENAME.items():
            if k in stats:
                arr = np.asarray(stats[k])
                if arr.ndim >= 2:  # (chain, draw, ...) per-draw stats
                    sample_stats[name] = arr
                elif k == "step_size" and arr.ndim == 1 and n_draws:
                    # final per-chain value; broadcast to the arviz
                    # per-draw convention
                    sample_stats[name] = np.broadcast_to(
                        arr[:, None], (arr.shape[0], n_draws)
                    ).copy()
    out = {"posterior": posterior, "sample_stats": sample_stats}
    try:  # pragma: no cover - arviz not in the base image
        import arviz as az

        return az.from_dict(posterior=posterior, sample_stats=sample_stats)
    except ImportError:
        return out


def summary_table(trace, var_names=None):
    """Formatted text summary (the reference prints its summary map;
    this renders exmc_tpu_torch.diagnostics.summary as an aligned table)."""
    from exmc_tpu_torch.diagnostics import summary

    rows = summary(trace, var_names)
    if not rows:
        return "(no free parameters)"
    cols = ["mean", "std", "q5", "q50", "q95", "ess", "ess_bulk", "rhat"]
    width = max(len(k) for k in rows) + 2
    lines = [" " * width + "".join(f"{c:>10}" for c in cols)]
    for name, r in rows.items():
        lines.append(
            f"{name:<{width}}" + "".join(f"{r[c]:>10.3f}" for c in cols)
        )
    return "\n".join(lines)
