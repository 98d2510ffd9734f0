"""FL algorithms as planners (the port's twin of the JAX package's
``core/algorithms.py``) — the shared planner base, FedAvg, FedProx,
RingOptimization, HierFAVG and FedSR.

A planner consumes only the host RNG, the config and its host-side state,
and emits ``RoundPlan``s; ``run_schedule`` pre-plans a block of rounds into
a ``Schedule`` and hands it to the engine (round by round under the
sequential and batched engines, as one call under the fused engine). Every
draw happens in the reference's order, so the port's plans are
bit-identical to the JAX package's for the same seed. MOON, SCAFFOLD and
Centralized are ROADMAP A4; the scenario, adversary and DP axes are
ROADMAP A7.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.configs.base import FLConfig
from repro_torch.core.comm import CommMeter, ResidencyMeter
from repro_torch.core.engines import make_engine
from repro_torch.core.local import LocalTrainer
from repro_torch.core.plan import (
    GLOBAL, AggSpec, Hop, RoundPlan, Schedule, VisitGroup,
)
from repro_torch.core.ring import ring_lap_hops
from repro_torch.core.scenario import ScenarioState
from repro_torch.core.topology import assign_edges, clusters_of, sample_ring
from repro_torch.data.pipeline import ClientData, plan_epoch_indices


class _Planner:
    """Shared planner base: sampling/weights helpers + the block runner."""

    variant = "plain"
    _transfers_per_client = 1       # model each way

    def __init__(self, trainer: LocalTrainer, clients: List[ClientData],
                 fl: FLConfig):
        if fl.adversary.active:
            raise NotImplementedError(
                "adversaries are not ported yet (ROADMAP A7)")
        self.trainer = trainer
        self.clients = clients
        self.fl = fl
        self.engine = make_engine(trainer, clients, fl)
        self.edges = assign_edges(fl.num_devices, fl.num_edges)
        self.scenario = ScenarioState(fl.scenario, fl.num_devices)
        self.residency = ResidencyMeter()

    # -- the block runner -------------------------------------------------
    def run_schedule(self, w_glob, t0, lrs, rng: np.random.Generator,
                     meter: CommMeter, state: Dict):
        """Pre-plan ``len(lrs)`` rounds (consuming the RNG stream exactly as
        ``len(lrs)`` single-round calls would), run them as one block and
        apply the block's closed-form comm records."""
        sched = self.plan_schedule(t0, len(lrs), rng, state)
        w_glob = self.dispatch_block(sched, w_glob, lrs, state)
        self.finish_block(sched, state, meter)
        return w_glob, state

    def dispatch_block(self, sched: Schedule, w_glob, lrs, state: Dict):
        """Stage the block's data, record residency and run the block, with
        the algorithm's state update between rounds where the engine runs
        round by round."""
        data_bytes = self.engine.stage_data(sched.visited())
        self.residency.record(data_bytes, 0)
        return self.engine.run_schedule(sched, w_glob, lrs, state,
                                        self.update_state)

    def update_state(self, plan: RoundPlan, w_before, w_after, lr: float,
                     state: Dict) -> None:
        """The algorithm's state update after one round; the ported
        planners keep no state."""

    def finish_block(self, sched: Schedule, state: Dict,
                     meter: CommMeter) -> None:
        """Apply the block's closed-form comm records and simulated time."""
        if meter is not None:
            for channel, count in sched.comm:
                meter.record(channel, count)
            # round by round (not a pre-summed block total), so the float
            # stream does not depend on the block size
            for plan in sched.plans:
                meter.record_time(plan.sim_seconds)

    def plan_schedule(self, t0: int, n: int, rng: np.random.Generator,
                      state: Dict) -> Schedule:
        """``n`` rounds of plans, drawn in the per-round RNG order."""
        plans = tuple(self.plan_round(t0 + k, rng, state) for k in range(n))
        totals: Dict[str, int] = {}
        for plan in plans:
            for channel, count in plan.comm:
                totals[channel] = totals.get(channel, 0) + count
        return Schedule(plans=plans, comm=tuple(sorted(totals.items())))

    def plan_round(self, t: int, rng: np.random.Generator,
                   state: Dict) -> RoundPlan:
        """The algorithm's pure plan, stamped with its simulated time."""
        plan = self._plan_round(t, rng, state)
        return dataclasses.replace(
            plan, sim_seconds=self.scenario.plan_seconds(plan))

    def _plan_round(self, t: int, rng: np.random.Generator,
                    state: Dict) -> RoundPlan:
        raise NotImplementedError

    # -- algorithm state in checkpoints (the plain algorithms keep none) ---
    def state_to_ckpt(self, state: Dict) -> Dict:
        """State carry -> the per-client-id dict layout of
        ``algo_state.msgpack``."""
        return dict(state)

    def state_from_ckpt(self, ck: Dict, w_glob) -> Dict:
        """Inverse of ``state_to_ckpt`` over a restored checkpoint."""
        return dict(ck)

    # -- planning helpers ------------------------------------------------
    def _batch_plan(self, i: int, rng: np.random.Generator) -> np.ndarray:
        return plan_epoch_indices(self.clients[i], self.fl.batch_size,
                                  self.fl.local_epochs, rng)

    def _sample(self, rng: np.random.Generator) -> List[int]:
        k = self.fl.num_devices
        n = max(1, int(round(k * self.fl.participation)))
        return sorted(rng.choice(k, size=n, replace=False).tolist())

    def _weights(self, ids: List[int]) -> np.ndarray:
        sizes = np.asarray([len(self.clients[i]) for i in ids], np.float64)
        return sizes / sizes.sum()

    def _ring_hops(self, rings: List[List[int]],
                   rng: np.random.Generator) -> Tuple[Hop, ...]:
        """The lap sequence of concurrent rings as (R * max-size) hops.

        Plans are drawn ring-by-ring, lap-by-lap — the sequential engine's
        visit order. Hop j past a shorter ring's end repeats the ring's
        first device with a ``None`` plan (the lane's model is carried
        unchanged)."""
        fl = self.fl
        plans = {}
        for r, ring in enumerate(rings):
            for lap in range(fl.ring_rounds):
                for j, i in enumerate(ring):
                    plans[r, lap, j] = self._batch_plan(i, rng)
        width = max(len(r) for r in rings)
        return tuple(
            Hop(ids=tuple(ring[j] if j < len(ring) else ring[0]
                          for ring in rings),
                plans=tuple(plans[r, lap, j] if j < len(ring) else None
                            for r, ring in enumerate(rings)))
            for lap in range(fl.ring_rounds) for j in range(width)
        )


class FedAvg(_Planner):
    """McMahan et al. 2017 — the star baseline (paper Fig. 1): one cohort
    visit group, flat |D_i|/|D| aggregation."""

    def _plan_round(self, t, rng, state):
        ids = self._sample(rng)
        plans = tuple(self._batch_plan(i, rng) for i in ids)
        group = VisitGroup(hops=(Hop(tuple(ids), plans),),
                           variant=self.variant,
                           shared_extras=self._extra_specs(ids, state),
                           agg=AggSpec.flat(self._weights(ids)))
        n = self._transfers_per_client * len(ids)
        return RoundPlan(groups=(group,),
                         comm=(("cloud_down", n), ("cloud_up", n)))

    def _extra_specs(self, ids, state) -> Dict:
        """The cohort-shared extras of one visit; values are the ``GLOBAL``
        sentinel, which the engines resolve at run time, so a whole
        Schedule can be planned up front."""
        return {}


class FedProx(FedAvg):
    """Li et al. 2020 — proximal term mu/2 ||w - w_glob||^2."""
    variant = "prox"

    def _extra_specs(self, ids, state):
        return {"anchor": GLOBAL}       # cohort-shared, broadcast to lanes


class RingOptimization(_Planner):
    """Paper §III-B standalone baseline: ONE global ring over all sampled
    devices, R laps per round; no cloud aggregation inside the ring."""

    def _plan_round(self, t, rng, state):
        fl = self.fl
        ring = self._sample(rng)
        if fl.reshuffle_ring:
            rng.shuffle(ring)
        comm = (("cloud_down", 1),          # seed the first device
                ("p2p", ring_lap_hops(len(ring), fl.ring_rounds)),
                ("cloud_up", 1))            # readout
        groups = ()
        if fl.ring_rounds > 0:
            groups = (VisitGroup(hops=self._ring_hops([ring], rng),
                                 agg=AggSpec.flat([1.0])),)
        return RoundPlan(groups=groups, comm=comm)


class HierFAVG(_Planner):
    """Liu et al. 2020 — hierarchical FedAvg: R edge-level FedAvg iterations
    per cloud round (the same R as FedSR's laps). Planned as R chained
    visit groups — iteration r's lanes are the (edge, device) pairs,
    seeded from iteration r-1's per-edge aggregates; only the final group
    collapses the edge models into the cloud model."""

    def _plan_round(self, t, rng, state):
        fl = self.fl
        edge_ids, plans = [], {}
        for e, edge_devices in enumerate(self.edges):
            ids = sample_ring(edge_devices, rng,
                              participation=fl.participation, reshuffle=False)
            edge_ids.append(ids)
            for r in range(fl.ring_rounds):
                for i in ids:
                    plans[e, r, i] = self._batch_plan(i, rng)
        pairs = [(e, i) for e, ids in enumerate(edge_ids) for i in ids]
        lane_w, agg_groups, off = [], [], 0
        for ids in edge_ids:
            lane_w += self._weights(ids).tolist()
            agg_groups.append(tuple(range(off, off + len(ids))))
            off += len(ids)
        sizes = [sum(len(self.clients[i]) for i in ids) for ids in edge_ids]
        total = float(sum(sizes))
        groups = tuple(
            VisitGroup(
                hops=(Hop(tuple(i for _, i in pairs),
                          tuple(plans[e, r, i] for e, i in pairs)),),
                seed=None if r == 0 else tuple(e for e, _ in pairs),
                agg=AggSpec(
                    groups=tuple(agg_groups), lane_weights=tuple(lane_w),
                    group_weights=(tuple(s / total for s in sizes)
                                   if r == fl.ring_rounds - 1 else None)))
            for r in range(fl.ring_rounds)
        )
        comm = []
        for ids in edge_ids:
            comm += [("cloud_down", 1),
                     ("edge_down", fl.ring_rounds * len(ids)),
                     ("edge_up", fl.ring_rounds * len(ids)),
                     ("cloud_up", 1)]
        return RoundPlan(groups=groups, comm=tuple(comm))


class FedSR(_Planner):
    """Algorithm 1 — semi-decentralized star-ring.

    Each edge server rings its sampled devices (with partial participation,
    clusters of ``devices_per_edge`` formed from the sampled pool), runs
    ring-optimization for R laps, and the cloud aggregates the M edge
    models weighted by |D_m|/|D| (eq. 11). Planned as ONE visit group whose
    lanes are the rings."""

    def _plan_round(self, t, rng, state):
        fl = self.fl
        if fl.participation >= 1.0:
            rings = [sample_ring(e, rng, reshuffle=fl.reshuffle_ring)
                     for e in self.edges]
        else:
            rings = clusters_of(self._sample(rng), fl.devices_per_edge, rng)
        sizes = [sum(len(self.clients[i]) for i in r) for r in rings]
        total = float(sum(sizes))
        comm = (("cloud_down", len(rings)),  # w_glob -> edges
                ("p2p", sum(ring_lap_hops(len(r), fl.ring_rounds)
                            for r in rings)),
                ("cloud_up", len(rings)))    # edge models -> cloud
        groups = ()
        if fl.ring_rounds > 0:
            groups = (VisitGroup(
                hops=self._ring_hops(rings, rng),
                agg=AggSpec.flat([s / total for s in sizes])),)
        return RoundPlan(groups=groups, comm=comm)


ALGORITHMS = {"fedavg": FedAvg, "fedprox": FedProx,
              "ring": RingOptimization, "hieravg": HierFAVG, "fedsr": FedSR}
_NOT_PORTED = ("moon", "scaffold", "centralized")


def make_algorithm(name: str, trainer: LocalTrainer,
                   clients: List[ClientData], fl: FLConfig):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported yet (ROADMAP A4); the port "
            f"runs {sorted(ALGORITHMS)}")
    if name not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {name!r}")
    return ALGORITHMS[name](trainer, clients, fl)
