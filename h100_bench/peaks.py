"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the full 700 W limit). The port turns TF32 off
(``exmc_tpu_torch.config.prepare_device``), so float32 work is held to the
non-tensor float32 rate."""

FLOAT32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
