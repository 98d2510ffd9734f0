from repro_torch.checkpoint.io import restore, save

__all__ = ["restore", "save"]
