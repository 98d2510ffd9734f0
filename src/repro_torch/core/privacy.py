"""(eps, delta) accounting for the opt-in DP-SGD path (the port's twin of
the JAX package's ``core/privacy.py``).

``LocalTrainer`` (``core.local``) clips every per-lane gradient step to
L2 norm ``dp_clip`` and adds Gaussian noise with std
``dp_noise_mult * dp_clip`` — the subsampled Gaussian mechanism, one
invocation per executed local SGD step. This module is the ledger: a
moments-accountant-style Renyi-DP composition over those steps,
accumulated by the planner next to the ``CommMeter`` and reported as
``ExperimentResult.dp_epsilon``/``dp_delta``. It is closed-form host
math, so the port's readout equals the reference's exactly.

Accounting model (worst-case client): each client's privacy loss grows
with ITS executed step count, so the ledger advances by the MAX per-client
steps of every plan (``plan_max_client_steps`` is closed-form on the
RoundPlan IR — dropped/ghost lanes have ``None`` plans and cost nothing).

RDP bounds used (sigma = noise multiplier, q = sampling rate):

* q = 1 (full local batch, the simulator's default): the exact Gaussian
  mechanism RDP, ``rdp(alpha) = alpha / (2 sigma^2)``;
* q < 1: the standard cheap bound for the subsampled mechanism,
  ``rdp(alpha) = min(q^2 alpha / sigma^2, alpha / (2 sigma^2))``
  (Abadi et al.'s moments bound in its small-q form, clamped by the
  unsubsampled mechanism).

Conversion: ``eps = min_alpha T * rdp(alpha) + log(1/delta) / (alpha-1)``.
"""
from __future__ import annotations

import math
from typing import Tuple

from repro_torch.core.plan import RoundPlan

# standard accountant grid of Renyi orders (alpha > 1)
ORDERS: Tuple[float, ...] = (
    1.25, 1.5, 1.75, 2.0, 2.5, 3.0, 4.0, 6.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def rdp_per_step(noise_mult: float, sample_rate: float = 1.0,
                 orders: Tuple[float, ...] = ORDERS) -> Tuple[float, ...]:
    """Per-step RDP cost at each order for one (subsampled) Gaussian
    mechanism invocation. ``noise_mult=0`` (clip-only) is infinitely
    leaky at every order."""
    if noise_mult <= 0:
        return tuple(math.inf for _ in orders)
    s2 = noise_mult * noise_mult
    out = []
    for a in orders:
        gauss = a / (2.0 * s2)
        if sample_rate >= 1.0:
            out.append(gauss)
        else:
            out.append(min(sample_rate * sample_rate * a / s2, gauss))
    return tuple(out)


class PrivacyLedger:
    """Accumulate RDP over executed DP-SGD steps; convert on demand."""

    def __init__(self, noise_mult: float, delta: float = 1e-5,
                 sample_rate: float = 1.0,
                 orders: Tuple[float, ...] = ORDERS):
        if not 0.0 < delta < 1.0:
            raise ValueError(f"delta={delta} must be in (0, 1)")
        self.noise_mult = noise_mult
        self.delta = delta
        self.orders = orders
        self.steps = 0
        self._per_step = rdp_per_step(noise_mult, sample_rate, orders)

    def record(self, steps: int) -> None:
        """Advance the ledger by ``steps`` mechanism invocations."""
        if steps < 0:
            raise ValueError(f"steps={steps} must be >= 0")
        self.steps += int(steps)

    def epsilon(self) -> float:
        """Tightest eps at the ledger's delta across the order grid."""
        if self.steps == 0:
            return 0.0
        log_inv = math.log(1.0 / self.delta)
        return min(self.steps * r + log_inv / (a - 1.0)
                   for a, r in zip(self.orders, self._per_step))

    @property
    def spent(self) -> Tuple[float, float]:
        return self.epsilon(), self.delta


def plan_max_client_steps(plan: RoundPlan) -> int:
    """Worst-case per-CLIENT executed step count of one plan — the number
    of DP mechanism invocations the ledger charges for the round. A ring
    lane interleaves several clients, so steps attribute to the visited
    client of each hop, not to the lane."""
    per_client: dict = {}
    for grp in plan.groups:
        for hop in grp.hops:
            for i, p in zip(hop.ids, hop.plans):
                if p is not None:
                    per_client[i] = per_client.get(i, 0) + p.shape[0]
    return max(per_client.values(), default=0)
