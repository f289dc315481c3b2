"""exmc_tpu_torch: the PyTorch/CUDA port of exmc_tpu.

The JAX package ``exmc_tpu`` is the reference; this package mirrors its
module names and is held against it by ``tests/test_torch_*.py``. It
imports torch, numpy and the standard library only. Entry points run on
``device="cuda"`` unless the caller asks for ``"cpu"``.
"""

from exmc_tpu_torch import dists
from exmc_tpu_torch.advi import advi_fit
from exmc_tpu_torch.chees import sample_chees, sample_snaper
from exmc_tpu_torch.compiler import compile_logp
from exmc_tpu_torch.dsl import Model
from exmc_tpu_torch.ir import IR, Builder, Node
from exmc_tpu_torch.meads import sample_meads
from exmc_tpu_torch.nuts.sampler import (
    NUTSSampler,
    sample,
    sample_chains,
    sample_stream,
)
from exmc_tpu_torch.optimize import fit_map, laplace
from exmc_tpu_torch.pathfinder import pathfinder_fit
from exmc_tpu_torch.psir import psir
from exmc_tpu_torch import stan

__all__ = ["Builder", "IR", "Node", "Model", "dists", "compile_logp",
           "NUTSSampler", "sample", "sample_chains", "sample_stream", "stan",
           "fit_map", "laplace", "psir", "advi_fit", "pathfinder_fit",
           "sample_chees", "sample_snaper", "sample_meads"]
