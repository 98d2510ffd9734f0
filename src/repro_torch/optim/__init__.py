from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import (
    constant, cosine_decay, robbins_monro, warmup_cosine,
)
from repro_torch.optim.sgd import SGD

__all__ = ["AdamW", "SGD", "constant", "cosine_decay", "robbins_monro",
           "warmup_cosine"]
