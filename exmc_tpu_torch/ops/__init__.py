from exmc_tpu_torch.ops.fused_leapfrog import fused_leapfrog_gaussian

__all__ = ["fused_leapfrog_gaussian"]
