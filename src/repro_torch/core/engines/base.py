"""Shared engine plumbing (the port's twin of the JAX package's
``core/engines/base.py``): what every plan interpreter holds, the
run-time resolution of ``GLOBAL`` and ``StateRef`` (through a staged
block's fleet→cohort row map), the residency and prefetch hooks the
block runner calls, and the per-round reference
implementation of the Schedule block driver (``run``/``run_schedule``)
that the sequential and batched engines use.
"""
from __future__ import annotations

from typing import Callable, List

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.plan import (
    GLOBAL, RoundPlan, RoundResult, Schedule, StateRef, VisitGroup,
)


class Engine:
    """Base plan interpreter: subclasses implement ``_run_group``.

    ``run`` walks the plan's visit groups, handing each group's aggregate
    to the next (HierFAVG's edge iterations seed from it); the final
    group's collapsed aggregate is the round's global model. Engines never
    touch the comm meter (the executor applies ``plan.comm``) and never
    draw from the RNG stream (planners pre-draw every batch plan).
    ``state`` is the algorithm's device-resident memory (``core.state``):
    plans name it only through ``StateRef``, resolved here at run time."""

    def __init__(self, trainer, clients: List, fl: FLConfig):
        self.trainer = trainer
        self.clients = clients
        self.fl = fl
        self.data_axis = fl.mesh_data_axis or "data"
        self.mesh = None        # the sim mesh (batched and fused engines)

    @staticmethod
    def _resolve(value, w_glob: torch.Tensor, state=None):
        """A plan extra at run time: ``GLOBAL`` is ``w_glob``; a
        ``StateRef`` is the global model while its client is unseen and
        ``fallback_global`` is set, the state entry itself for
        ``client < 0`` (SCAFFOLD's server variate), else the client's row
        of the stack — under a staged store the row of the block's
        ``(V + 1, P)`` cohort carry that ``state["_rowmap"]`` maps the
        fleet id to."""
        if value is GLOBAL:
            return w_glob
        if isinstance(value, StateRef):
            if value.fallback_global and not state["seen"][value.client]:
                return w_glob       # the client has no row yet
            entry = state[value.field]
            if value.client < 0:
                return entry
            rowmap = state.get("_rowmap")
            row = value.client if rowmap is None else int(
                rowmap[value.client])
            return entry[row]
        return value

    def stage_data(self, visited) -> int:
        """Residency hook, called once per block with the block's visited
        fleet ids: make their data resident and return the resident bytes.
        Only the fused engine keeps a device plane; the host-fed engines
        move batches from the shards where they live, so they stage
        nothing and report no device residency."""
        return 0

    def prefetch_data(self, visited) -> None:
        """Pipeline hook (``FLConfig.prefetch=1``): start staging the next
        block's data while the current block runs. The host-fed engines
        have nothing to stage."""

    def stage_pair_nbytes(self) -> int:
        """Arena bytes live at once at the last block hand-over (both
        pipeline buffers under prefetch, one otherwise); 0 for engines
        without a device arena."""
        return 0

    def staging_stats(self):
        """(stage_seconds, overlapped_stage_seconds) of the engine's store
        — zeros for engines that never stage."""
        return 0.0, 0.0

    def run(self, plan: RoundPlan, w_glob: torch.Tensor, lr: float,
            state=None) -> RoundResult:
        """One round: the final group's collapsed aggregate (no groups:
        ``w_glob`` unchanged) and, with ``keep_locals``, that group's
        trained lanes as one (C, P) stack."""
        result = RoundResult(w_glob)
        prev = None     # the previous group's aggregate
        for grp in plan.groups:
            prev, locals_ = self._run_group(grp, w_glob, prev, lr, state)
            if grp.agg.collapsed:
                result.w_glob = prev
            if grp.keep_locals:
                result.locals_ = (torch.stack(locals_)
                                  if isinstance(locals_, list) else locals_)
        return result

    def run_schedule(self, sched: Schedule, w_glob: torch.Tensor, lrs,
                     state, update_fn: Callable) -> torch.Tensor:
        """Reference block driver: one ``run`` per plan, threading the
        global model and applying the algorithm's state update
        (``update_fn(plan, w_before, result, lr, state)``) between
        rounds — per-round semantics behind the block API. The fused
        engine overrides this with one call per block."""
        for plan, lr in zip(sched.plans, lrs):
            lr = float(lr)
            result = self.run(plan, w_glob, lr, state)
            update_fn(plan, w_glob, result, lr, state)
            w_glob = result.w_glob
        return w_glob

    def _run_group(self, grp: VisitGroup, w_glob: torch.Tensor, prev,
                   lr: float, state):
        """Execute one visit group, its seeded lanes starting from rows of
        ``prev`` (the previous group's G edge models); returns
        ``(aggregate, lanes)``: the (P,) model when ``grp.agg`` collapses,
        else the G per-group models, and the trained lanes (a list of (P,)
        models or a (C, P) stack; None when not kept)."""
        raise NotImplementedError

    def _loss_kwargs(self, grp: VisitGroup, w_glob: torch.Tensor,
                     state) -> dict:
        """The group's loss variant and its cohort-shared extras as keyword
        arguments of the trainer, resolved (``_resolve``)."""
        return dict(variant=grp.variant,
                    **{k: self._resolve(v, w_glob, state)
                       for k, v in grp.shared_extras.items()})
