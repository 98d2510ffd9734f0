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
from repro_torch.core.plan import GLOBAL, RoundPlan, Schedule, VisitGroup


def check_ported_plans(plans: Sequence[RoundPlan]) -> None:
    """Refuse what the port's engines cannot run yet: loss variants other
    than ``"plain"`` and FedProx's ``"prox"`` (MOON's and SCAFFOLD's). A
    Schedule's plans share group structure, so the first plan with groups
    decides."""
    plan = next((p for p in plans if p.groups), None)
    if plan is None:
        return
    for grp in plan.groups:
        if grp.variant not in ("plain", "prox"):
            raise NotImplementedError(
                f"loss variant {grp.variant!r} is not ported yet "
                "(ROADMAP A4)")


class Engine:
    """Base plan interpreter: subclasses implement ``_run_group``.

    ``run`` walks the plan's visit groups, handing each group's aggregate
    to the next (HierFAVG's edge iterations seed from it); the final
    group's collapsed aggregate is the round's global model. Engines never
    touch the comm meter (the executor applies ``plan.comm``) and never
    draw from the RNG stream (planners pre-draw every batch plan)."""

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
        """One round: returns the final group's collapsed aggregate (no
        groups: ``w_glob`` unchanged)."""
        out, prev = w_glob, None    # prev: the previous group's aggregate
        for grp in plan.groups:
            prev = self._run_group(grp, w_glob, prev, lr)
            if grp.agg.collapsed:
                out = prev
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

    def _run_group(self, grp: VisitGroup, w_glob: torch.Tensor, prev,
                   lr: float):
        """Execute one visit group, its seeded lanes starting from rows of
        ``prev`` (the previous group's G edge models); returns its
        aggregate: the (P,) model when ``grp.agg`` collapses, else the G
        per-group models."""
        raise NotImplementedError

    @staticmethod
    def _loss_kwargs(grp: VisitGroup, w_glob: torch.Tensor) -> dict:
        """The group's loss variant and its cohort-shared extras as keyword
        arguments of the trainer, ``GLOBAL`` resolved to ``w_glob``."""
        return dict(variant=grp.variant,
                    **{k: w_glob if v is GLOBAL else v
                       for k, v in grp.shared_extras.items()})
