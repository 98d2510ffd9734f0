from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_decode_step, ssd_reference

__all__ = ["ssd_decode_step", "ssd_reference", "ssd_scan"]
