"""Multi-device and multi-host parallelism (``exmc_tpu/parallel``).

The JAX package runs one program over a device mesh; the port runs one
process per device under ``torch.distributed`` (SPMD), each holding its
own chains:

* chain parallelism — chains split over the "dp" ranks, each running
  the NUTS pipeline of its block with no collective in the tree loop;
  pooled adaptation and the ensemble rescue reduce over "dp" at window
  ends (``sample_chains_sharded``; ``sample_chees(mesh=...)``);
* data parallelism — the log-density's observation rows split over the
  "sp" ranks, one ``all_reduce`` per value-and-grad
  (``parallel.sharding``);
* diagnostics — split and nested R-hat and ESS over the chains of all
  ranks, moments combined by ``all_reduce`` (``parallel.diagnostics``);
* multi-host — ``initialize_distributed()`` forms the process group
  (NCCL for one rank per card, gloo on the CPU or for ranks sharing a
  card); ``torchrun --nproc-per-node N`` starts one rank per card.
"""

from exmc_tpu_torch.parallel.sharding import (
    make_mesh,
    data_parallel_vag,
    shard_chains,
)
from exmc_tpu_torch.parallel.distributed import (
    initialize_distributed,
    sample_chains_sharded,
)
from exmc_tpu_torch.parallel.diagnostics import (
    sharded_ess,
    sharded_nested_rhat,
    sharded_rhat,
)

__all__ = [
    "make_mesh",
    "data_parallel_vag",
    "shard_chains",
    "initialize_distributed",
    "sample_chains_sharded",
    "sharded_rhat",
    "sharded_ess",
    "sharded_nested_rhat",
]
