"""RoundPlan IR — the declarative schedule of one FL round (the port's
twin of the JAX package's ``core/plan.py``).

Algorithms are pure planners: they consume only the host RNG, the config
and their host-side state and emit plans; engines interpret them. A plan is
a sequence of ``VisitGroup``s; a group trains C *lanes* concurrently for H
*hops* — hop ``h`` of lane ``c`` visits client ``hops[h].ids[c]`` with the
pre-drawn batch plan ``hops[h].plans[c]`` (``None``: the lane's model is
carried unchanged, the ring-tail rule). A FedSR round is one group whose
lanes are the edge rings and whose H = R * max-ring-size hops are the lap
sequence, closed by the eq.-11 weighted cloud reduce (``AggSpec``). A
HierFAVG round is R chained groups: each lane restarts from its edge's
model, the previous group's uncollapsed per-edge aggregate (``seed``).

Plans never hold the global model or the algorithms' state: ``GLOBAL``
marks "the current global model" where a group's extras refer to it
(FedProx's anchor, MOON's positive), ``StateRef`` a row or entry of the
algorithm's device-resident state (``core.state``: MOON's previous locals,
SCAFFOLD's variates), and the engine resolves both at run time, so a whole
block of rounds can be planned before any of them runs. The adversary's
per-lane delta transform rides a group as ``lane_scale``; a Byzantine-robust
reduce (``core.robust``) rides its ``AggSpec`` as ``reducer``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


class _Symbol:
    """Sentinel resolved by the engine at run time."""

    def __init__(self, name: str):
        self._name = name

    def __repr__(self) -> str:
        return f"<{self._name}>"


GLOBAL = _Symbol("GLOBAL")      # the current global model


@dataclasses.dataclass(frozen=True)
class StateRef:
    """A reference into the algorithm's device-resident state, resolved by
    the engine at run time: entry ``field`` of the state, row ``client`` of
    its (K + 1, P) client stack (``-1``: the entry is one unstacked (P,)
    model, SCAFFOLD's server variate). With ``fallback_global`` it resolves
    to the current global model until the client's row has been written
    (MOON's "the previous local defaults to the global model"); the state's
    host ``seen`` mask decides, so resolving never reads the device."""

    field: str
    client: int = -1
    fallback_global: bool = False


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """Two-level linear reduce over a group's lanes (eq. 11 as data).

    Lanes are gathered into ``groups`` (the edges); each group's model is
    the ``lane_weights``-weighted sum of its lanes. With ``group_weights``
    the group models collapse into ONE model (the cloud reduce); without,
    the reduce stops at the (G, ...) group stack (HierFAVG's intermediate
    edge iterations, which seed the next group). Aggregation is linear, so
    ``matrix`` folds both levels of a collapsed reduce into one effective
    per-lane weight vector.

    ``reducer`` replaces the per-group weighted sum with a robust order
    statistic over the group's valid lanes (``core.robust``: ``median``,
    ``trimmed_mean`` with ``trim_frac``, ``krum`` with ``krum_f``); a lane
    is valid where its weight is above 0, and the statistic is unweighted.
    The group level stays the linear ``group_weights`` mean.
    """

    groups: Tuple[Tuple[int, ...], ...]      # lane indices per group
    lane_weights: Tuple[float, ...]          # weight of each lane IN its group
    group_weights: Optional[Tuple[float, ...]] = None
    reducer: str = "weighted_mean"           # weighted_mean|median|trimmed_mean|krum
    trim_frac: float = 0.0                   # per-side trim (trimmed_mean)
    krum_f: int = 0                          # assumed Byzantine lanes (krum)

    def __post_init__(self):
        if self.reducer not in ("weighted_mean", "median", "trimmed_mean",
                                "krum"):
            raise ValueError(f"unknown reducer {self.reducer!r}")

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

    def reduce_kwargs(self, pad_to: int) -> Dict[str, Any]:
        """The reduce operands of ``LocalTrainer.train_many``:
        ``weighted_mean`` ships the collapsed ``matrix``; a robust reducer
        ships the uncollapsed (G, pad_to) lane-weight matrix (its > 0
        pattern is the validity mask), the (G,) group weights (None for an
        uncollapsed reduce) and its own knobs."""
        if self.reducer == "weighted_mean":
            return {"agg": self.matrix(pad_to)}
        wm = dataclasses.replace(self, group_weights=None).matrix(pad_to)
        gw = (np.asarray(self.group_weights, np.float32)
              if self.collapsed else None)
        return {"agg": wm, "agg_gw": gw, "reducer": self.reducer,
                "trim_frac": self.trim_frac, "krum_f": self.krum_f}


@dataclasses.dataclass(frozen=True)
class Hop:
    """One concurrent visit of every lane: lane c trains client ``ids[c]``
    on batch plan ``plans[c]`` (``None`` = carried unchanged)."""

    ids: Tuple[int, ...]
    plans: Tuple[Optional[np.ndarray], ...]


@dataclasses.dataclass(frozen=True)
class VisitGroup:
    """H hop-sequenced concurrent visits over C lanes, then the ``agg``
    reduce.

    ``seed`` is where each lane's model comes from: ``None`` broadcasts the
    global model to every lane; otherwise ``seed[c]`` indexes the previous
    group's (G, ...) aggregate stack. ``shared_extras`` are the loss
    variant's cohort-shared inputs (FedProx's ``{"anchor": GLOBAL}``,
    SCAFFOLD's ``{"c_glob": StateRef("c")}``), ``stacked_extras`` hold one
    entry a lane (MOON's ``w_prev``, SCAFFOLD's ``c_local``: a
    ``StateRef`` into a client stack each). ``keep_locals`` asks the engine
    to return the final group's trained lanes too (MOON's and SCAFFOLD's
    state updates read them).

    ``lane_scale`` is the adversary's per-lane delta transform
    (``core.adversary``): before the group's reduce, lane c's trained
    model becomes ``ref + lane_scale[c] * (model - ref)``, ``ref`` the
    lane's seed (-1.0: a sign-flipped upload, above 1: an amplified one).
    ``None`` (every honest round) skips the transform, so honest plans
    run exactly as they did without an adversary; the kept lanes are the
    transformed ones, as in the reference."""

    hops: Tuple[Hop, ...]
    variant: str = "plain"
    shared_extras: Dict[str, Any] = dataclasses.field(default_factory=dict)
    stacked_extras: Dict[str, Tuple[Any, ...]] = dataclasses.field(
        default_factory=dict)
    seed: Optional[Tuple[int, ...]] = None
    agg: Optional[AggSpec] = None
    keep_locals: bool = False
    lane_scale: Optional[Tuple[float, ...]] = None

    @property
    def lanes(self) -> int:
        return len(self.hops[0].ids)

    def lane_steps(self) -> List[int]:
        """Each lane's executed SGD steps, from the plans (engines need not
        report them back from the device)."""
        return [sum(h.plans[c].shape[0] for h in self.hops
                    if h.plans[c] is not None)
                for c in range(self.lanes)]


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """One round: chained visit groups + closed-form comm records. The
    round's output is the final group's collapsed aggregate (no groups —
    e.g. ring_rounds=0 — leaves the global model unchanged). ``comm`` and
    ``sim_seconds`` are applied to the meter by the executor."""

    groups: Tuple[VisitGroup, ...]
    comm: Tuple[Tuple[str, int], ...] = ()
    sim_seconds: float = 0.0

    def __post_init__(self):
        for g, grp in enumerate(self.groups):
            if not grp.hops:
                raise ValueError(f"group {g}: a VisitGroup needs >= 1 hop")
            if grp.seed is not None and g == 0:
                raise ValueError("group 0 cannot seed from a previous group")
            if grp.seed is not None and self.groups[g - 1].agg is None:
                # a seeded group indexes its predecessor's AGGREGATE stack
                raise ValueError(f"group {g}: missing previous aggregate")
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
        """Sorted fleet ids of every client any hop of the block names.
        Ring-tail repeats and scenario-dropped lanes count: their rows are
        still gathered (under an all-invalid mask), so they must be
        staged."""
        ids = {i for p in self.plans for g in p.groups for h in g.hops
               for i in h.ids}
        return np.asarray(sorted(ids), np.int64)


@dataclasses.dataclass
class RoundResult:
    """What an engine hands back after one round: the round's (P,) global
    model and, when the final group has ``keep_locals``, its trained lanes
    as one (C, P) stack."""

    w_glob: Any
    locals_: Optional[Any] = None
