"""Shared engine plumbing (the port's twin of the JAX package's
``core/engines/base.py``): what every plan interpreter holds, the
residency hooks the block runner calls, and the per-round reference
implementation of the Schedule block driver (``run``/``run_schedule``)
that the sequential and batched engines use.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.plan import RoundPlan, Schedule, VisitGroup


def check_ported_plans(plans: Sequence[RoundPlan]) -> None:
    """Refuse what the port's engines cannot run yet: multi-group (seeded,
    HierFAVG) plans and loss variants other than ``"plain"``. A Schedule's
    plans share group structure, so the first plan with groups decides."""
    plan = next((p for p in plans if p.groups), None)
    if plan is None:
        return
    if len(plan.groups) > 1:
        raise NotImplementedError(
            "multi-group (HierFAVG) schedules are not ported yet "
            "(ROADMAP A4)")
    variant = plan.groups[0].variant
    if variant != "plain":
        raise NotImplementedError(
            f"loss variant {variant!r} is not ported yet (ROADMAP A4)")


class Engine:
    """Base plan interpreter: subclasses implement ``_run_group``.

    ``run`` walks the plan's visit groups; the final group's collapsed
    aggregate is the round's global model. Engines never touch the comm
    meter (the executor applies ``plan.comm``) and never draw from the RNG
    stream (planners pre-draw every batch plan)."""

    def __init__(self, trainer, clients: List, fl: FLConfig):
        self.trainer = trainer
        self.clients = clients
        self.fl = fl

    def stage_data(self, visited) -> int:
        """Residency hook, called once per block with the block's visited
        fleet ids: make their data resident and return the resident bytes.
        Only the fused engine keeps a device plane; the host-fed engines
        move batches from the shards where they live, so they stage
        nothing and report no device residency."""
        return 0

    def staging_stats(self):
        """(stage_seconds, overlapped_stage_seconds) of the engine's store
        — zeros for engines that never stage."""
        return 0.0, 0.0

    def run(self, plan: RoundPlan, w_glob: torch.Tensor,
            lr: float) -> torch.Tensor:
        """One round: every group from ``w_glob``; returns the final
        group's collapsed aggregate (no groups: ``w_glob`` unchanged)."""
        out = w_glob
        for grp in plan.groups:
            agg = self._run_group(grp, w_glob, lr)
            if grp.agg.collapsed:
                out = agg
        return out

    def run_schedule(self, sched: Schedule, w_glob: torch.Tensor, lrs,
                     state, update_fn: Callable) -> torch.Tensor:
        """Reference block driver: one ``run`` per plan, threading the
        global model and applying the algorithm's state update
        (``update_fn(plan, w_before, w_after, lr, state)``) between
        rounds — per-round semantics behind the block API. The fused
        engine overrides this with one call per block."""
        check_ported_plans(sched.plans)
        for plan, lr in zip(sched.plans, lrs):
            lr = float(lr)
            w_new = self.run(plan, w_glob, lr)
            update_fn(plan, w_glob, w_new, lr, state)
            w_glob = w_new
        return w_glob

    def _run_group(self, grp: VisitGroup, w_glob: torch.Tensor,
                   lr: float) -> torch.Tensor:
        """Execute one visit group; returns its aggregate."""
        raise NotImplementedError
