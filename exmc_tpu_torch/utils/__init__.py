"""Run tools (``exmc_tpu/utils``): fault injection, checkpoints, the
disk-backed trace store and profiling hooks."""

from exmc_tpu_torch.utils.fault_injector import FaultInjector
from exmc_tpu_torch.utils.checkpoint import save_checkpoint, load_checkpoint
from exmc_tpu_torch.utils.trace_store import TraceStore
from exmc_tpu_torch.utils.profiling import (annotate, annotated_run,
                                            phase_report, trace_profile)

__all__ = ["FaultInjector", "save_checkpoint", "load_checkpoint", "trace_profile",
           "annotate", "annotated_run", "phase_report", "TraceStore"]
