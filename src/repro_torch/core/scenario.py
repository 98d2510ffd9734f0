"""The simulated clock of the scenario axis.

Only the clock is ported: every round's closed-form simulated time
(``plan_seconds``) is stamped on its plan and accumulated on the comm
meter, as in the JAX package's ``core/scenario.py``. Drops, slow clients
and stale uploads — an ``active`` scenario — are ROADMAP A7.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ScenarioConfig
from repro_torch.core.plan import RoundPlan


class ScenarioState:
    """Per-experiment clock realization: each client's compute rate, drawn
    once from the scenario's own seed (never the experiment stream)."""

    def __init__(self, cfg: ScenarioConfig, num_devices: int):
        if cfg.active:
            raise NotImplementedError(
                "drop/slow/stale scenarios are not ported yet (ROADMAP A7)")
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.rates = rng.uniform(cfg.rate_min, cfg.rate_max, size=num_devices)

    def plan_seconds(self, plan: RoundPlan) -> float:
        """Closed-form simulated round time: a lane accumulates (steps /
        client rate + one transfer) per real visit, a group takes as long
        as its slowest lane, the round adds the cloud broadcast + upload,
        and ``time_threshold`` (if set) caps the round clock."""
        if not plan.groups:
            return 0.0
        cfg = self.cfg
        total = 0.0
        for grp in plan.groups:
            lane_t = np.zeros(grp.lanes)
            for hop in grp.hops:
                for c, (i, p) in enumerate(zip(hop.ids, hop.plans)):
                    if p is not None:
                        lane_t[c] += (p.shape[0] / self.rates[i]
                                      + cfg.transfer_seconds)
            total += float(lane_t.max())
        total += 2 * cfg.transfer_seconds       # cloud down + up
        if cfg.time_threshold > 0:
            total = min(total, cfg.time_threshold)
        return total
