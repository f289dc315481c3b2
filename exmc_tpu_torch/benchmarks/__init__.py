"""Benchmarks of the port: the seven-model suite (``suite.py``) and the
card tasks of ``chip_smoke.py``."""

from exmc_tpu_torch.benchmarks.suite import MODELS, build_model, run_model, run_suite

__all__ = ["MODELS", "build_model", "run_model", "run_suite"]
