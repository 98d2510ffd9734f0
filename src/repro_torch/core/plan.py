"""RoundPlan IR — the declarative schedule of one FL round (the port's
twin of the JAX package's ``core/plan.py``).

Algorithms are pure planners: they consume only the host RNG, the config
and their host-side state and emit plans; engines interpret them. A plan is
a sequence of ``VisitGroup``s; a group trains C *lanes* concurrently for H
*hops* — hop ``h`` of lane ``c`` visits client ``hops[h].ids[c]`` with the
pre-drawn batch plan ``hops[h].plans[c]`` (``None``: the lane's model is
carried unchanged, the ring-tail rule). A FedSR round is one group whose
lanes are the edge rings and whose H = R * max-ring-size hops are the lap
sequence, closed by the eq.-11 weighted cloud reduce (``AggSpec``).

Only what FedSR plans is ported; the fields for per-lane extras, seeded
groups and adversarial lane scales come with the algorithms that use them
(ROADMAP A5, A7).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """Two-level linear reduce over a group's lanes (eq. 11 as data).

    Lanes are gathered into ``groups``; each group's model is the
    ``lane_weights``-weighted sum of its lanes, and ``group_weights``
    collapse the group models into ONE model. Aggregation is linear, so
    ``matrix`` folds both levels into one effective per-lane weight vector.
    """

    groups: Tuple[Tuple[int, ...], ...]      # lane indices per group
    lane_weights: Tuple[float, ...]          # weight of each lane IN its group
    group_weights: Optional[Tuple[float, ...]] = None
    reducer: str = "weighted_mean"

    def __post_init__(self):
        if self.reducer != "weighted_mean":
            raise NotImplementedError(
                f"reducer {self.reducer!r} is not ported yet (ROADMAP A7)")

    @classmethod
    def flat(cls, weights: Sequence[float]) -> "AggSpec":
        """One group of all lanes, collapsed: sum_i w_i * lane_i."""
        return cls(groups=(tuple(range(len(weights))),),
                   lane_weights=tuple(float(w) for w in weights),
                   group_weights=(1.0,))

    @property
    def collapsed(self) -> bool:
        """True when the reduce yields ONE model (the round/cloud output)."""
        return self.group_weights is not None

    def matrix(self, pad_to: int) -> np.ndarray:
        """The reduction array contracted against the (C, ...) lane stack:
        ``(pad_to,)`` effective weights when ``collapsed``, else
        ``(G, pad_to)``. Ghost lanes past the real lane count weigh 0."""
        C = len(self.lane_weights)
        if pad_to < C:
            raise ValueError(f"pad_to={pad_to} < lane count {C}")
        W = np.zeros((len(self.groups), pad_to), np.float32)
        for g, lanes in enumerate(self.groups):
            for lane in lanes:
                W[g, lane] = self.lane_weights[lane]
        if not self.collapsed:
            return W
        return np.asarray(self.group_weights, np.float32) @ W     # (pad_to,)


@dataclasses.dataclass(frozen=True)
class Hop:
    """One concurrent visit of every lane: lane c trains client ``ids[c]``
    on batch plan ``plans[c]`` (``None`` = carried unchanged)."""

    ids: Tuple[int, ...]
    plans: Tuple[Optional[np.ndarray], ...]


@dataclasses.dataclass(frozen=True)
class VisitGroup:
    """H hop-sequenced concurrent visits over C lanes, each lane seeded
    from the global model, then the ``agg`` reduce."""

    hops: Tuple[Hop, ...]
    variant: str = "plain"
    agg: Optional[AggSpec] = None

    @property
    def lanes(self) -> int:
        return len(self.hops[0].ids)


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """One round: visit groups + closed-form comm records. The round's
    output is the final group's collapsed aggregate (no groups — e.g.
    ring_rounds=0 — leaves the global model unchanged). ``comm`` and
    ``sim_seconds`` are applied to the meter by the executor."""

    groups: Tuple[VisitGroup, ...]
    comm: Tuple[Tuple[str, int], ...] = ()
    sim_seconds: float = 0.0

    def __post_init__(self):
        for g, grp in enumerate(self.groups):
            if not grp.hops:
                raise ValueError(f"group {g}: a VisitGroup needs >= 1 hop")
        if self.groups:
            last = self.groups[-1].agg
            if last is None or not last.collapsed:
                raise ValueError(
                    "the final group must collapse to ONE model "
                    "(AggSpec with group_weights)")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A block of pre-planned rounds — the unit the executor dispatches
    between evals. ``comm`` is the block sum of the plans' records."""

    plans: Tuple[RoundPlan, ...]
    comm: Tuple[Tuple[str, int], ...] = ()

    def __post_init__(self):
        shapes = {(len(p.groups),) + tuple(g.variant for g in p.groups)
                  for p in self.plans}
        if len(shapes) > 1:
            raise ValueError(
                f"a Schedule's plans must share group structure: {shapes}")

    def visited(self) -> np.ndarray:
        """Sorted fleet ids of every client any hop of the block names."""
        ids = {i for p in self.plans for g in p.groups for h in g.hops
               for i in h.ids}
        return np.asarray(sorted(ids), np.int64)
