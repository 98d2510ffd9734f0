"""Attacker models as data and plan transforms (the port's twin of the JAX
package's ``core/adversary.py``).

Two attack families, at the seam the scenario axis uses:

* **label_flip** — a data poison: every attacker shard's labels are
  permuted (``label -> num_classes - 1 - label``) once, before training
  (``poison_clients``, applied by the executor right after
  ``make_clients`` and before the engine stages any data). Plans are
  untouched.
* **sign_flip / scale** — Byzantine uploads: an attacked lane's
  contribution to the reduce becomes ``ref + t * (model - ref)`` with
  ``t = -1`` (a sign-flipped delta) or ``t = scale`` (an amplified one),
  ``ref`` being the lane's seed model. The transform rides the plan as
  ``VisitGroup.lane_scale`` and every engine applies it to the trained
  lanes just before the group's reduce.

A ring lane is attacked when any of its members with a real visit is an
attacker: one Byzantine device poisons its whole ring lap. The attackers
are drawn once from ``AdversaryConfig.seed``, never from the experiment
stream, and the transform draws nothing, so attack-off runs are
bit-identical to adversary-free ones and attack-on runs plan the same
rounds.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.configs.base import AdversaryConfig
from repro_torch.core.plan import RoundPlan, VisitGroup
from repro_torch.data.partition import poison_labels


class AdversaryState:
    """Per-experiment attacker realization: the attacker subset, drawn
    once from the adversary's own seed."""

    def __init__(self, cfg: AdversaryConfig, num_devices: int):
        self.cfg = cfg
        self.num_devices = num_devices
        self.attackers = np.zeros(num_devices, bool)
        if cfg.active:
            rng = np.random.default_rng(cfg.seed)
            n = int(round(num_devices * cfg.frac))
            if n > 0:
                idx = rng.choice(num_devices, size=n, replace=False)
                self.attackers[idx] = True

    @property
    def active(self) -> bool:
        return self.cfg.active and bool(self.attackers.any())

    @property
    def byzantine(self) -> bool:
        """True for the attacks that transform uploads (not the data)."""
        return self.active and self.cfg.kind in ("sign_flip", "scale")

    # -- the plan transform ---------------------------------------------
    def transform(self, plan: RoundPlan) -> RoundPlan:
        """Stamp ``lane_scale`` on every aggregated group whose lanes hold
        an attacker with a real visit. Draws nothing."""
        if not self.byzantine or not plan.groups:
            return plan
        t = -1.0 if self.cfg.kind == "sign_flip" else float(self.cfg.scale)
        groups = tuple(self._transform_group(g, t) for g in plan.groups)
        return dataclasses.replace(plan, groups=groups)

    def _transform_group(self, grp: VisitGroup, t: float) -> VisitGroup:
        if grp.agg is None:
            return grp
        scale = tuple(
            t if any(self.attackers[hop.ids[c]]
                     and hop.plans[c] is not None for hop in grp.hops)
            else 1.0
            for c in range(grp.lanes))
        if all(s == 1.0 for s in scale):
            return grp
        return dataclasses.replace(grp, lane_scale=scale)

    # -- the data poison ------------------------------------------------
    def poison_clients(self, clients: List, num_classes: int) -> List:
        """label_flip: permute every attacker shard's labels (applied once
        by the executor, before any training)."""
        if not (self.active and self.cfg.kind == "label_flip"):
            return clients
        out = list(clients)
        for i, client in enumerate(out):
            if self.attackers[i]:
                out[i] = dataclasses.replace(
                    client, labels=poison_labels(client.labels, num_classes))
        return out
