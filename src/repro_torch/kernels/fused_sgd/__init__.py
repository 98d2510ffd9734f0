from repro_torch.kernels.fused_sgd.ops import fused_sgd_lanes

__all__ = ["fused_sgd_lanes"]
