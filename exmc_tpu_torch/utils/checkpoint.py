"""Checkpoint / resume of a run's tuning (``exmc_tpu/utils/checkpoint.py``).

Save the step sizes and inverse masses (and optionally the final
positions, the seed and extra arrays) after a run; resume later with
``sample(..., warm_start=ckpt["warm_start"])``, a 50-iteration
fine-tune instead of the full warmup. The file is a plain ``.npz`` of
the JAX package's layout, so either package reads the other's.
"""

import numpy as np


def save_checkpoint(path, stats, *, seed=None, positions=None, extra=None):
    """Persist tuning (+ optionally final positions) from a ``sample``
    stats dict."""
    payload = {
        "step_size": np.asarray(stats["step_size"]),
        "inv_mass": np.asarray(stats["inv_mass"]),
    }
    if positions is not None:
        payload["positions"] = np.asarray(positions)
    if seed is not None:
        payload["seed"] = np.asarray(seed)
    if extra:
        for k, v in extra.items():
            payload[f"extra_{k}"] = np.asarray(v)
    np.savez(path, **payload)


def load_checkpoint(path):
    """Load a checkpoint; ``ckpt["warm_start"]`` plugs straight into
    ``sample(..., warm_start=...)``. Per-chain tuning arrays stay per
    chain: ``sample`` takes them when the chain counts match and raises
    when they don't (resume with the same num_chains, or index chain 0
    yourself)."""
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    out["warm_start"] = {
        "step_size": out["step_size"],
        "inv_mass": out["inv_mass"],
    }
    return out
