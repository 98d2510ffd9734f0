from repro_torch.optim.schedules import cosine_decay

__all__ = ["cosine_decay"]
