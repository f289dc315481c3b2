"""exmc_tpu_torch: the PyTorch/CUDA port of exmc_tpu.

The JAX package ``exmc_tpu`` is the reference; this package mirrors its
module names and is held against it by ``tests/test_torch_*.py``. It
imports torch, numpy, scipy and the standard library only. Entry points
run on ``device="cuda"`` unless the caller asks for ``"cpu"``.
``__all__`` is the JAX package's and the subpackage ``particle``. As in
the JAX package, ``exmc_tpu_torch.parallel`` (sampling over several
devices, ``torch.distributed``), ``exmc_tpu_torch.utils`` (fault
injection, checkpoints, the trace store, profiling) and
``exmc_tpu_torch.viz`` (the live monitor) are imported on their own.
"""

from exmc_tpu_torch import dists
from exmc_tpu_torch.ir import IR, Builder, Node
from exmc_tpu_torch.dsl import Model
from exmc_tpu_torch.compiler import compile_for_sampling, compile_logp, compile_pointwise
from exmc_tpu_torch.point_map import PointMap
from exmc_tpu_torch.nuts.sampler import (
    NUTSSampler,
    sample,
    sample_chains,
    sample_stream,
)
from exmc_tpu_torch.chees import sample_chees, sample_snaper
from exmc_tpu_torch.meads import sample_meads
from exmc_tpu_torch.advi import advi_fit
from exmc_tpu_torch.flows import flow_fit, sample_neutra
from exmc_tpu_torch.smc import smc_sample
from exmc_tpu_torch.pathfinder import pathfinder_fit
from exmc_tpu_torch.optimize import fit_map, laplace
from exmc_tpu_torch.psir import psir
from exmc_tpu_torch import diagnostics
from exmc_tpu_torch import gp
from exmc_tpu_torch import hmm
from exmc_tpu_torch import glm
from exmc_tpu_torch import particle
from exmc_tpu_torch import log_prob
from exmc_tpu_torch import model_comparison
from exmc_tpu_torch import predictive
from exmc_tpu_torch import sbc
from exmc_tpu_torch import stan
from exmc_tpu_torch import transforms

__all__ = [
    "IR",
    "Node",
    "Builder",
    "Model",
    "PointMap",
    "compile_logp",
    "compile_for_sampling",
    "compile_pointwise",
    "sample",
    "sample_chains",
    "sample_chees",
    "sample_snaper",
    "sample_meads",
    "sample_stream",
    "advi_fit",
    "flow_fit",
    "sample_neutra",
    "smc_sample",
    "pathfinder_fit",
    "fit_map",
    "laplace",
    "psir",
    "dists",
    "diagnostics",
    "gp",
    "hmm",
    "glm",
    "particle",
    "log_prob",
    "model_comparison",
    "predictive",
    "sbc",
    "stan",
    "transforms",
]
