"""Learning-rate schedules: the paper's cosine decay (§IV-C / Fig. 6), the
Robbins–Monro schedule of its convergence theorem (eq. 20), a constant and
the large-model runtime's warmup-cosine (the port's twin of the JAX
package's ``optim/schedules.py``).

Each is evaluated step by step in float32, as the JAX package evaluates
it, and returns an ``np.float32``. It matches the reference to the last
bit except where XLA's float32 ``cos`` or ``pow`` rounds differently from
the correctly rounded one used here (below 2**-23 relative, scaled by the
schedule's span).
"""
from __future__ import annotations

import math

import numpy as np

f32 = np.float32


def cosine_decay(init_lr: float = 0.01, final_lr: float = 1e-5,
                 total_rounds: int = 500):
    """eta_t = final + 0.5(init-final)(1+cos(pi t/T))."""
    half_span = f32(0.5 * (init_lr - final_lr))

    def lr(t) -> np.float32:
        frac = f32(t) / f32(max(total_rounds, 1))
        frac = f32(min(max(frac, f32(0.0)), f32(1.0)))
        c = f32(math.cos(float(f32(f32(math.pi) * frac))))
        return f32(f32(final_lr) + half_span * f32(f32(1.0) + c))

    return lr


def robbins_monro(c: float = 0.01, power: float = 1.0):
    """eta_t = c / (t+1)^power; satisfies eq. (20) for 0.5 < power <= 1."""
    assert 0.5 < power <= 1.0

    def lr(t) -> np.float32:
        base = f32(f32(t) + f32(1.0))
        return f32(f32(c) / f32(float(base) ** float(f32(power))))

    return lr


def constant(lr_value: float):
    def lr(t) -> np.float32:
        return f32(lr_value)

    return lr


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  final_lr: float = 0.0):
    """Large-model runtime schedule: linear warmup to ``peak_lr`` over
    ``warmup`` steps, then cosine decay to ``final_lr`` at ``total``."""
    half_span = f32(0.5 * (peak_lr - final_lr))

    def lr(t) -> np.float32:
        t = f32(t)
        if t < f32(warmup):
            return f32(f32(peak_lr) * t / f32(max(warmup, 1)))
        frac = f32(t - f32(warmup)) / f32(max(total - warmup, 1))
        frac = f32(min(max(frac, f32(0.0)), f32(1.0)))
        c = f32(math.cos(float(f32(f32(math.pi) * frac))))
        return f32(f32(final_lr) + half_span * f32(f32(1.0) + c))

    return lr
