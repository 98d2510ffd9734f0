"""Straggler and dropout scenarios as a RoundPlan transform (the port's
twin of the JAX package's ``core/scenario.py``).

IoT fleets drop, lag and send stale updates. The plan IR already
expresses all three — varying participation is a ``None`` plan, partial
work a shorter valid-step mask, aggregation weights are data — so the
scenario axis is a pure transform that the planner base applies to every
emitted plan (``_Planner.plan_round``):

* **drop** — a per-round draw removes a fixed fraction of the round's
  participants: every one of their visits becomes a ``None`` plan (rings
  skip them, cohort lanes carry the seed unchanged), lanes that lose all
  members get aggregation weight 0 and the survivors' weights are
  renormalized. At least one participant always survives.
* **train-slow** — a fixed subset of the fleet (drawn once per experiment)
  completes only ``slow_step_factor`` of each planned visit: its batch
  plans are truncated, which every engine runs as a shorter valid-step
  mask. Truncation happens after the plan is drawn, so it draws nothing.
* **send-slow / stale** — another fixed subset uploads late: each round
  such a client's update is ``s ~ Uniform{1..staleness_horizon}`` rounds
  stale and its lane weight decays by the FedAsync polynomial
  ``(1 + s)^-a`` before renormalization.

The transform rewrites plan data only, so the engines run it unchanged:
a fused eval-to-eval block under an active scenario is still one call,
and an inactive scenario never runs the transform and never draws.

The simulated clock (``plan_seconds``) is closed-form on the final plan:
per-client compute time is executed steps over a per-client rate (drawn
once per experiment), each real visit ends in one model transfer, a group
takes as long as its slowest lane, and the round adds the cloud broadcast
and upload; ``time_threshold`` caps the round clock. The block runner
accumulates it on ``CommMeter.sim_seconds``.

Every draw is the reference's numpy call, in its order, with its argument
types, so plans and the RNG stream are bit-identical to the JAX
package's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.configs.base import ScenarioConfig
from repro_torch.core.plan import AggSpec, Hop, RoundPlan, VisitGroup


class ScenarioState:
    """Per-experiment scenario realization: which clients are train-slow
    and send-slow and how fast each computes, drawn once from the
    scenario's own seed in that order (never the experiment stream, so
    constructing it changes no plan and resume stays exact)."""

    def __init__(self, cfg: ScenarioConfig, num_devices: int):
        self.cfg = cfg
        self.num_devices = num_devices
        rng = np.random.default_rng(cfg.seed)
        self.train_slow = np.zeros(num_devices, bool)
        self.send_slow = np.zeros(num_devices, bool)
        if cfg.train_slow_frac > 0:
            n = int(round(num_devices * cfg.train_slow_frac))
            idx = rng.choice(num_devices, size=n, replace=False)
            self.train_slow[idx] = True
        if cfg.send_slow_frac > 0:
            n = int(round(num_devices * cfg.send_slow_frac))
            idx = rng.choice(num_devices, size=n, replace=False)
            self.send_slow[idx] = True
        self.rates = rng.uniform(cfg.rate_min, cfg.rate_max, size=num_devices)

    @property
    def active(self) -> bool:
        return self.cfg.active

    # -- per-round outcome draws (from the shared planner RNG) -----------
    def draw_round(self, plan: RoundPlan, rng: np.random.Generator,
                   ) -> Tuple[Set[int], Dict[int, int]]:
        """This round's ``(dropped ids, {id: staleness})``: the drops first
        (a fixed fraction of the sorted participants, at least one left),
        then the staleness of each sorted send-slow survivor."""
        cfg = self.cfg
        participants = plan_participants(plan)
        dropped: Set[int] = set()
        if cfg.drop_rate > 0 and len(participants) > 1:
            n_drop = min(int(round(len(participants) * cfg.drop_rate)),
                         len(participants) - 1)
            if n_drop > 0:
                dropped = {int(i) for i in rng.choice(
                    participants, size=n_drop, replace=False)}
        stale: Dict[int, int] = {}
        if cfg.send_slow_frac > 0 and cfg.staleness_horizon > 0:
            for i in participants:
                if self.send_slow[i] and i not in dropped:
                    stale[i] = int(rng.integers(1, cfg.staleness_horizon + 1))
        return dropped, stale

    # -- the plan transform ---------------------------------------------
    def transform(self, plan: RoundPlan, rng: np.random.Generator,
                  ) -> Tuple[RoundPlan, Set[int]]:
        """Apply the scenario to one plan; returns the rewritten plan and
        the dropped ids (the planners rebuild comm records from them)."""
        if not plan.groups:
            return plan, set()
        dropped, stale = self.draw_round(plan, rng)
        groups = tuple(self._transform_group(g, dropped, stale)
                       for g in plan.groups)
        return dataclasses.replace(plan, groups=groups), dropped

    def _transform_group(self, grp: VisitGroup, dropped: Set[int],
                         stale: Dict[int, int]) -> VisitGroup:
        cfg = self.cfg
        hops = []
        for hop in grp.hops:
            plans = []
            for i, p in zip(hop.ids, hop.plans):
                if p is None or i in dropped:
                    plans.append(None)
                elif self.train_slow[i]:
                    keep = max(1, int(np.ceil(p.shape[0]
                                              * cfg.slow_step_factor)))
                    plans.append(p[:keep])
                else:
                    plans.append(p)
            hops.append(Hop(ids=hop.ids, plans=tuple(plans)))
        hops = tuple(hops)
        agg = grp.agg
        if agg is not None:
            # a lane's factor: 0 when it lost every member, else the
            # FedAsync decay of its stalest surviving member
            factor = np.ones(grp.lanes)
            for c in range(grp.lanes):
                members = {hop.ids[c] for hop in hops
                           if hop.plans[c] is not None}
                if not members:
                    factor[c] = 0.0
                elif stale:
                    s = max((stale.get(i, 0) for i in members), default=0)
                    if s:
                        factor[c] = (1.0 + s) ** (-cfg.staleness_decay)
            agg = _rescale_agg(agg, factor)
        return dataclasses.replace(grp, hops=hops, agg=agg)

    # -- the simulated clock --------------------------------------------
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


def plan_participants(plan: RoundPlan) -> List[int]:
    """Sorted client ids with at least one real visit in the plan."""
    out = {int(hop.ids[c])
           for grp in plan.groups for hop in grp.hops
           for c in range(grp.lanes) if hop.plans[c] is not None}
    return sorted(out)


def _rescale_agg(agg: AggSpec, factor: np.ndarray) -> AggSpec:
    """Scale lane weights by ``factor`` and renormalize within each group
    (a group's surviving lanes share its mass again); groups that lost
    every lane get group weight 0 and the group weights are renormalized
    in turn. A collapsed spec with no group left raises."""
    lw = np.asarray(agg.lane_weights, np.float64) * factor
    sums = np.asarray([lw[list(g)].sum() for g in agg.groups])
    for g, lanes in enumerate(agg.groups):
        if sums[g] > 0:
            for lane in lanes:
                lw[lane] /= sums[g]
    gw: Optional[Tuple[float, ...]] = agg.group_weights
    if gw is not None:
        gv = np.asarray(gw, np.float64) * (sums > 0)
        total = gv.sum()
        if total <= 0:
            raise ValueError(
                "scenario dropped every lane of a collapsed aggregation")
        gw = tuple((gv / total).tolist())
    return dataclasses.replace(
        agg, lane_weights=tuple(lw.tolist()), group_weights=gw)
