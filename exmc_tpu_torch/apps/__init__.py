"""Demo application domains (``exmc_tpu/apps``): the inverse heat
problem (``physics``) and Bayesian poker opponent profiling (``poker``)."""
