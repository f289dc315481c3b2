"""Multi-process chain distribution over ``torch.distributed``
(``exmc_tpu/parallel/distributed.py``).

* ``initialize_distributed()`` forms the process group: one process per
  device, NCCL for one rank per card, gloo on the CPU or for ranks that
  share a card;
* chain fan-out: each rank along "dp" runs the NUTS pipeline of its own
  block of chains, with no collective in the tree loop; the pooled
  Welford merge and the ensemble rescue reduce over "dp" at window ends,
  and with "sp" > 1 each value-and-grad reduces over "sp";
* results: every rank gathers the whole trace (a zero-padded
  ``all_reduce`` on the host under gloo);
* fault recovery: NaN-level faults are absorbed inside the pipeline
  (divergences, dead-chain re-init in warmup); chains dead after warmup
  are re-dispatched as a fresh run and spliced in
  (``_redispatch_failed_chains``).

Unlike the JAX package, a failed launch is not retried in place: a rank
that raises leaves its peers waiting in a collective, so the peers raise
when the group's ``timeout`` passes, and the run fails on every rank
instead of hanging.

Randomness: rank r along "dp" runs its chains with the seed
``seed + r * RANK_SEED_STRIDE``, so rank 0 of any mesh, and a mesh of
one rank, reproduce the unsharded run of the same seed bit for bit; the
ranks along "sp" share their seed and run the same chains.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from exmc_tpu_torch.compiler import CompiledModel, compile_logp
from exmc_tpu_torch.nuts.sampler import _SAMPLER_OPT_KEYS, NUTSSampler
from exmc_tpu_torch.parallel.sharding import make_data_parallel_vag, make_mesh, shard_data

RANK_SEED_STRIDE = 1_000_003
RETRY_SEED_OFFSET = 104729
DEFAULT_TIMEOUT_S = 600.0

# the sampler options sample_chains_sharded passes on
KNOWN_OPTS = tuple(k for k in _SAMPLER_OPT_KEYS if k != "shared_warmup")


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, *, backend="nccl",
                           timeout_s=DEFAULT_TIMEOUT_S):
    """Form the process group (the JAX package's multi-host bring-up).
    No-op, returning False, when ``coordinator_address`` is None.

    ``coordinator_address``: ``"tcp://host:port"``, ``"host:port"``,
    ``"file:///path"`` or ``"env://"`` (``torchrun``'s variables).
    ``backend``: "nccl" for one rank per card (the rank's card becomes
    the current device: ``LOCAL_RANK``, else the rank modulo the card
    count), "gloo" on the CPU or for ranks sharing a card. A collective
    that waits longer than ``timeout_s`` raises."""
    if coordinator_address is None:
        return False
    addr = str(coordinator_address)
    if "://" not in addr:
        addr = f"tcp://{addr}"
    world = -1 if num_processes is None else int(num_processes)
    rank = -1 if process_id is None else int(process_id)
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            local = (rank if rank >= 0 else int(os.environ.get("RANK", 0)))
            local = local % torch.cuda.device_count()
        torch.cuda.set_device(int(local))
    dist.init_process_group(backend=backend, init_method=addr, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def rank_seed(seed, mesh):
    """The seed of this rank's chains: ``seed`` on dp rank 0."""
    return int(seed) + mesh.axis("dp").index * RANK_SEED_STRIDE


def sample_chains_sharded(ir, num_chains, mesh=None, *, seed=0, data=None,
                          ncp=True, shared_warmup=False, retry_failed=True,
                          **opts):
    """Multi-device multi-chain NUTS: ``num_chains`` split over the mesh's
    "dp" ranks, each running the pipeline of its block; every rank
    returns the whole (trace, stats), chains in rank order.

    With "sp" > 1 the likelihood is data-parallel too: the observation
    rows (registered with ``Builder.data``) split over "sp" and each
    value-and-grad sums the ranks' partial values and gradients. On one
    rank (``make_mesh()`` without a process group) this is the unsharded
    run of the same seed, bit for bit.

    stats adds ``chain_ok`` (finite logp at every kept draw),
    ``redispatched`` (dead chains replaced by a retry run) and
    ``host_syncs`` (this rank's)."""
    if mesh is None:
        mesh = make_mesh()
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if num_chains % dp != 0:
        raise ValueError(f"num_chains={num_chains} not divisible by dp={dp}")
    unknown = set(opts) - set(KNOWN_OPTS)
    if unknown:
        raise TypeError(f"unknown sampler options: {sorted(unknown)}")
    model = ir if isinstance(ir, CompiledModel) else compile_logp(ir, ncp=ncp,
                                                                  device=mesh.device)
    if data is None:
        data = model.data

    vag_builder = None
    if sp > 1:
        if data is None:
            raise ValueError(
                "sp>1 shards the likelihood over observation data rows: "
                "register data with Builder.data(ir, tensor)")
        dp_vag = make_data_parallel_vag(model, mesh)

        def vag_builder(ddata):
            shard = shard_data(mesh, model.device_data(ddata))
            return lambda q: dp_vag(q, shard)

    sampler = NUTSSampler(model=model, shared_warmup=shared_warmup,
                          vag_builder=vag_builder, group=mesh.axis("dp"),
                          **{k: opts[k] for k in KNOWN_OPTS if k in opts})
    draws, stats = sampler.run(num_chains=num_chains // dp, seed=rank_seed(seed, mesh),
                               data=data, return_unconstrained=True)
    host_syncs = sampler.last_run["host_syncs"]
    gather = _host_gather(mesh)
    draws = gather(draws)
    stats = {k: gather(v) for k, v in stats.items()}
    stats["host_syncs"] = host_syncs
    trace = sampler.constrain_trace(draws, data)
    return _redispatch_failed_chains(
        sampler, mesh, trace, stats, draws, data, seed,
        shared_warmup=shared_warmup, max_retries=1 if retry_failed else 0)


def _host_gather(mesh):
    """numpy (local chains, ...) -> numpy (all chains, ...), the same on
    every rank: a zero-padded ``all_reduce`` over "dp" (on the host
    under gloo); the identity without a process group."""
    axis = mesh.axis("dp")
    return lambda x: axis.gather_rows(np.asarray(x))


def _chain_health(stats):
    """Per-chain failure markers: a healthy chain has finite logp at
    every kept draw (a chain that died in warmup was already reset and
    counted in ``recoveries``)."""
    return np.isfinite(np.asarray(stats["logp"])).all(axis=-1)


def _redispatch_failed_chains(sampler, mesh, trace, stats, draws, data,
                              seed, *, shared_warmup=False, max_retries=1):
    """Surface per-chain failure markers and re-dispatch dead chains as a
    fresh (smaller) run on the same mesh instead of aborting the whole
    run. Healthy retry chains splice into the trace; chains still dead
    after ``max_retries`` stay marked in ``stats["chain_ok"]``. Every
    rank holds the same gathered stats, so all take the same branch."""
    ok = _chain_health(stats)
    stats["chain_ok"] = ok
    stats["redispatched"] = 0
    if ok.all() or max_retries < 1:
        return trace, stats

    dp = mesh.shape["dp"]
    bad_idx = np.flatnonzero(~ok)
    # pad to a dp multiple so the retry run splits evenly
    n_retry = max(int(np.ceil(len(bad_idx) / dp)) * dp, dp)
    retry_trace, retry_stats = sample_chains_sharded(
        sampler.model, n_retry, mesh, seed=seed + RETRY_SEED_OFFSET, data=data,
        shared_warmup=shared_warmup, retry_failed=False,
        **{k: getattr(sampler, k) for k in KNOWN_OPTS})
    healthy = np.flatnonzero(retry_stats["chain_ok"])[: len(bad_idx)]
    trace = {k: np.array(v) for k, v in trace.items()}
    stats = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
             for k, v in stats.items()}
    ok = np.array(ok)
    for i, j in zip(bad_idx[: len(healthy)], healthy):
        for k in trace:
            trace[k][i] = retry_trace[k][j]
        for k in ("logp", "diverging", "accept_prob", "depth", "step_size",
                  "inv_mass", "divergences"):
            if k in stats and k in retry_stats:
                stats[k][i] = retry_stats[k][j]
        ok[i] = True
    stats["chain_ok"] = ok
    stats["redispatched"] = len(healthy)
    return trace, stats
