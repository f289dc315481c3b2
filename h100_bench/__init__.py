"""The benchmark of ``exmc_tpu_torch`` on one NVIDIA H100: whole NUTS fits
through ``exmc_tpu_torch.sample``, timed by the host clock, checked
against plain references under ``reference/``. ``run.py`` is the
command; ``BENCHMARK.json`` at the repository root names the cells."""
