"""Learning-rate schedules (the paper's cosine decay, §IV-C / Fig. 6)."""
from __future__ import annotations

import math

import numpy as np


def cosine_decay(init_lr: float = 0.01, final_lr: float = 1e-5,
                 total_rounds: int = 500):
    """eta_t = final + 0.5(init-final)(1+cos(pi t/T)).

    Evaluated step by step in float32, as the JAX package evaluates it, so
    the schedule matches it to the last bit except where XLA's float32
    cosine rounds differently from the correctly rounded one used here;
    that error (below 2**-23) is scaled by the half span 0.5*(init-final).
    """
    f32 = np.float32
    half_span = f32(0.5 * (init_lr - final_lr))

    def lr(t) -> np.float32:
        frac = f32(t) / f32(max(total_rounds, 1))
        frac = f32(min(max(frac, f32(0.0)), f32(1.0)))
        c = f32(math.cos(float(f32(f32(math.pi) * frac))))
        return f32(f32(final_lr) + half_span * f32(f32(1.0) + c))

    return lr
