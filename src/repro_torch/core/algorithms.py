"""FL algorithms as planners (the port's twin of the JAX package's
``core/algorithms.py``) — the shared planner base and all eight algorithms
of the paper's tables: FedAvg, FedProx, MOON, SCAFFOLD, RingOptimization,
HierFAVG, FedSR and Centralized.

A planner consumes only the host RNG, the config and its host-side state,
and emits ``RoundPlan``s; ``run_schedule`` pre-plans a block of rounds into
a ``Schedule`` and hands it to the engine (round by round under the
sequential and batched engines, as one call under the fused engine). Every
draw happens in the reference's order, so the port's plans are
bit-identical to the JAX package's for the same seed.

MOON's previous local models and SCAFFOLD's control variates live on the
device (``core.state``): a (K + 1, P) client stack (and SCAFFOLD's (P,)
server variate) plus the host ``seen`` mask. Plans name them through
``StateRef``; the final group keeps its trained lanes (``keep_locals``)
and ``update_state`` folds them back after each round, or the fused
engine carries the state through its block with the same functions.
Centralized trains on the pooled shards and bypasses the plan IR.

Two opt-in axes layer onto every plan at one seam (``plan_round``): an
active scenario (``core.scenario``: drops, truncated visits, stale
uploads) rewrites the plan and its comm records, and a Byzantine
adversary (``core.adversary``) stamps ``lane_scale`` after the drops, so
an attacker that dropped this round uploads nothing. Off, neither runs
nor draws. Before both, the config's robust reducer (``FLConfig.reducer``)
is stamped onto every ``AggSpec`` of the plan (``_mark_agg``), which draws
nothing either. DP-SGD (``dp_clip > 0``) changes no plan: the local
trainer transforms each step's gradient, and the planner keeps the
privacy ledger (``core.privacy``), charged at ``finish_block`` with each
round's worst-case per-client steps (Centralized: each visit's steps).

The block boundary is also the residency protocol's boundary
(``FLConfig.store="host"`` or ``"stream"``): ``dispatch_block`` stages the
block's visited clients' state rows as ``(V + 1, P)`` cohort carries, with
the fleet→cohort ``_rowmap`` the engines read, asks the engine to stage
the cohort's data, records the residency and runs the block;
``finish_block`` writes the trained rows back into the host arenas. Under
the prefetch pipeline ``prefetch_block`` stages the next block's data in
the background while a block runs, and its state rows too when the two
blocks' visited sets are disjoint.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.adversary import AdversaryState
from repro_torch.core.comm import CommMeter, ResidencyMeter
from repro_torch.core.engines import make_engine
from repro_torch.core.local import LocalTrainer
from repro_torch.core.plan import (
    GLOBAL, AggSpec, Hop, RoundPlan, RoundResult, Schedule, StateRef,
    VisitGroup,
)
from repro_torch.core.privacy import PrivacyLedger, plan_max_client_steps
from repro_torch.core.ring import ring_lap_hops
from repro_torch.core.scenario import ScenarioState
from repro_torch.core.state import (
    client_stack, host_stack, pack_client_rows, rowmap_for, scaffold_step,
    scatter_rows, stage_rows, unpack_client_rows, unstage_rows,
)
from repro_torch.core.topology import assign_edges, clusters_of, sample_ring
from repro_torch.data.pipeline import (
    ClientData, client_weights, plan_epoch_indices,
)
from repro_torch.utils.tree import unravel


class _Planner:
    """Shared planner base: sampling/weights helpers + the block runner."""

    variant = "plain"
    keep_locals = False
    pipelinable = True              # False: the algorithm bypasses the
                                    # Schedule IR (Centralized); the
                                    # executor calls its run_schedule, and
                                    # the serial driver under prefetch=1
    _transfers_per_client = 1       # model each way (SCAFFOLD ships 2)
    _client_fields: Tuple[str, ...] = ()    # (K + 1, P) client stacks (host
                                            # arenas, staged per block, under
                                            # the staged stores)
    _shared_fields: Tuple[str, ...] = ()    # unstacked (P,) device models
                                            # (SCAFFOLD's server variate)

    def __init__(self, trainer: LocalTrainer, clients: List[ClientData],
                 fl: FLConfig):
        self.trainer = trainer
        self.clients = clients
        self.fl = fl
        self.engine = make_engine(trainer, clients, fl)
        self.edges = assign_edges(fl.num_devices, fl.num_edges)
        self.scenario = ScenarioState(fl.scenario, fl.num_devices)
        self.adversary = AdversaryState(fl.adversary, fl.num_devices)
        self.privacy = (PrivacyLedger(fl.dp_noise_mult, fl.dp_delta)
                        if fl.dp_clip > 0 else None)
        self.residency = ResidencyMeter()
        self._transient_state_bytes = 0     # the running block's staged
                                            # carries while the next
                                            # block's are staged early

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
        """Make the algorithm's state, stage the block's state rows and data
        (taking over what a matching ``prefetch_block`` staged), record the
        residency (data plane plus state bytes, and the double buffer's
        high-water mark) and run the block, with the algorithm's state
        update between rounds where the engine runs round by round."""
        self.ensure_state(state, w_glob)
        visited = sched.visited()
        self._stage_state(state, visited)
        data_bytes = self.engine.stage_data(visited)
        self.residency.record(data_bytes, self._staged_state_bytes(state))
        # both pipeline arenas at the hand-over, plus the previous block's
        # staged carries if this block's were staged while they were live
        self.residency.record_transient(
            self.engine.stage_pair_nbytes()
            + self._staged_state_bytes(state) + self._transient_state_bytes)
        self._transient_state_bytes = 0
        return self.engine.run_schedule(sched, w_glob, lrs, state,
                                        self.update_state)

    def prefetch_block(self, sched: Schedule, inflight_visited, state: Dict
                       ) -> None:
        """Overlap the next block's staging with the running block: its
        cohort data goes to the store's staging thread whatever the sets
        (an arena depends on no block), while its state rows are staged
        now only when the two blocks' visited sets are disjoint — the
        running block writes its own rows back when it retires, so rows it
        shares with the next block wait for ``finish_block`` and are
        staged by ``_stage_state``."""
        visited = sched.visited()
        self.engine.prefetch_data(visited)
        if (not self._staged_store or "_host" not in state
                or not self._client_fields or inflight_visited is None):
            return
        if np.intersect1d(inflight_visited, visited).size:
            return      # rows the running block will write: wait for it
        stash = {f: stage_rows(state["_host"][f], visited,
                               self.trainer.device)
                 for f in self._client_fields}
        # the stash and the running block's carries are both live now
        self._transient_state_bytes = self._staged_state_bytes(state)
        state["_stash"] = {"visited": visited, "rows": stash}

    @property
    def _staged_store(self) -> bool:
        """True for the stores that stage per block (host RAM or disk)."""
        return self.fl.store in ("host", "stream")

    def _stage_state(self, state: Dict, visited: np.ndarray) -> None:
        """Staged stores: upload the block's visited state rows as
        ``(V + 1, P)`` cohort carries and publish the fleet→cohort rowmap
        the engines read. A stash for the same visited set (staged while
        the previous block ran, from rows that block did not touch) is
        taken over instead of uploading again."""
        if not self._staged_store or "_host" not in state:
            return
        stash = state.pop("_stash", None)
        state["_visited"] = visited
        state["_rowmap"] = rowmap_for(visited, self.fl.num_devices)
        if stash is not None and np.array_equal(stash["visited"], visited):
            for f in self._client_fields:
                state[f] = stash["rows"][f]
        else:
            for f in self._client_fields:
                state[f] = stage_rows(state["_host"][f], visited,
                                      self.trainer.device)

    def _unstage_state(self, state: Dict) -> None:
        """Write the block's trained cohort rows back into the host arenas
        (one readback a field) and drop the staged carries."""
        if "_visited" not in state:
            return
        visited = state.pop("_visited")
        state.pop("_rowmap")
        for f in self._client_fields:
            state["_host"][f] = unstage_rows(state["_host"][f], visited,
                                             state.pop(f))

    def update_state(self, plan: RoundPlan, w_before, result: RoundResult,
                     lr: float, state: Dict) -> None:
        """The algorithm's state update after one round, from the round's
        result (its kept lanes); stateless algorithms have none."""

    def ensure_state(self, state: Dict, w_glob) -> None:
        """Make the algorithm's state carriers on first use (they need the
        model's size, so they cannot be made at construction)."""

    def _staged_state_bytes(self, state: Dict) -> int:
        """Device-resident algorithm-state bytes: the full (K + 1, P)
        stacks (the staged (V + 1, P) carries under a staged store) and
        the shared models."""
        return sum(state[f].numel() * state[f].element_size()
                   for f in self._client_fields + self._shared_fields
                   if f in state)

    def _state_rows(self, state: Dict, ids: np.ndarray,
                    live: np.ndarray) -> torch.Tensor:
        """Scatter targets of a round's state update, on the device: live
        lanes write their client's row, dead lanes the dump row K —
        cohort rows through ``state["_rowmap"]`` under a staged store."""
        rows = np.where(live, ids, self.fl.num_devices)
        rowmap = state.get("_rowmap")
        if rowmap is not None:
            rows = rowmap[rows]
        return torch.as_tensor(rows, dtype=torch.int64,
                               device=self.trainer.device)

    def finish_block(self, sched: Schedule, state: Dict,
                     meter: CommMeter) -> None:
        """Retire a block: write its trained state rows back into the host
        arenas (the staged stores' one readback, where the pipeline waits
        for the block) and apply its closed-form privacy and comm records
        and simulated time."""
        self._unstage_state(state)
        if self.privacy is not None:
            # worst-case client: each round's max per-client steps
            for plan in sched.plans:
                self.privacy.record(plan_max_client_steps(plan))
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
        """The algorithm's pure plan (``_plan_round``) with the config's
        reducer stamped on (``_mark_agg``), then, only when a scenario is
        active, its drop/slow/stale transform with rebuilt comm records,
        then a Byzantine adversary's ``lane_scale`` stamp (after the
        drops), and last the simulated-clock stamp. An inactive scenario
        never runs and never draws, and the reducer stamp and the
        adversary draw nothing, so their absence leaves plans and the RNG
        stream as the plain planner makes them."""
        plan = self._mark_agg(self._plan_round(t, rng, state))
        if self.scenario.active:
            plan, dropped = self.scenario.transform(plan, rng)
            plan = dataclasses.replace(
                plan, comm=self._scenario_comm(plan, dropped))
        if self.adversary.byzantine:
            plan = self.adversary.transform(plan)
        return dataclasses.replace(
            plan, sim_seconds=self.scenario.plan_seconds(plan))

    def _mark_agg(self, plan: RoundPlan) -> RoundPlan:
        """Stamp the config's robust reducer onto every ``AggSpec`` of the
        plan; ``weighted_mean`` returns the plan untouched."""
        fl = self.fl
        if fl.reducer == "weighted_mean":
            return plan
        groups = tuple(
            dataclasses.replace(g, agg=dataclasses.replace(
                g.agg, reducer=fl.reducer, trim_frac=fl.trim_frac,
                krum_f=fl.krum_f))
            if g.agg is not None else g
            for g in plan.groups)
        return dataclasses.replace(plan, groups=groups)

    def _plan_round(self, t: int, rng: np.random.Generator,
                    state: Dict) -> RoundPlan:
        raise NotImplementedError

    def _scenario_comm(self, plan: RoundPlan,
                       dropped: set) -> Tuple[Tuple[str, int], ...]:
        """Closed-form comm of the transformed plan, star form: the cloud
        broadcasts to every sampled client (a drop shows only when its
        upload never arrives) and the survivors upload, each transfer
        ``_transfers_per_client`` models."""
        if not plan.groups:
            return plan.comm
        grp = plan.groups[0]
        live = sum(1 for p in grp.hops[0].plans if p is not None)
        tpc = self._transfers_per_client
        return (("cloud_down", tpc * grp.lanes), ("cloud_up", tpc * live))

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
        return client_weights([self.clients[i] for i in ids])

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
        shared, stacked = self._extra_specs(ids, state)
        group = VisitGroup(
            hops=(Hop(tuple(ids), plans),), variant=self.variant,
            shared_extras=shared, stacked_extras=stacked,
            agg=AggSpec.flat(self._weights(ids)),
            keep_locals=self.keep_locals)
        n = self._transfers_per_client * len(ids)
        return RoundPlan(groups=(group,),
                         comm=(("cloud_down", n), ("cloud_up", n)))

    def _extra_specs(self, ids, state) -> Tuple[Dict, Dict]:
        """(shared, per-lane) extras of one cohort visit; the values are
        ``GLOBAL`` and ``StateRef`` sentinels, which the engines resolve at
        run time, so a whole Schedule can be planned up front."""
        return {}, {}


class FedProx(FedAvg):
    """Li et al. 2020 — proximal term mu/2 ||w - w_glob||^2."""
    variant = "prox"

    def _extra_specs(self, ids, state):
        return {"anchor": GLOBAL}, {}   # cohort-shared, broadcast to lanes


class Moon(FedAvg):
    """Li et al. 2021 — model-contrastive loss. ``state["prev"]`` is the
    (K + 1, P) stack of each client's previous local model (under a staged
    store a host (K, P) arena, ``state["_host"]["prev"]``, staged per
    block); a client that has not trained yet contrasts against the
    current global model (``StateRef.fallback_global`` and the host
    ``seen`` mask)."""
    variant = "moon"
    keep_locals = True
    _client_fields = ("prev",)

    def _extra_specs(self, ids, state):
        return ({"w_glob": GLOBAL},
                {"w_prev": tuple(StateRef("prev", i, fallback_global=True)
                                 for i in ids)})

    def ensure_state(self, state, w_glob):
        if "seen" in state:
            return
        if self._staged_store:
            state["_host"] = {"prev": host_stack(w_glob,
                                                 self.fl.num_devices)}
        else:
            state["prev"] = client_stack(w_glob, self.fl.num_devices)
        state["seen"] = np.zeros(self.fl.num_devices + 1, bool)

    def update_state(self, plan, w_before, result, lr, state):
        grp = plan.groups[0]
        ids = np.asarray(grp.hops[0].ids)
        # a lane that ran no step scatters to the dump row and stays unseen
        live = np.asarray(grp.lane_steps()) > 0
        state["prev"] = scatter_rows(state["prev"],
                                     self._state_rows(state, ids, live),
                                     result.locals_)
        state["seen"][ids[live]] = True

    def state_to_ckpt(self, state):
        stack = (state["_host"]["prev"] if "_host" in state
                 else state.get("prev"))
        if stack is None:
            return {}
        return {"prev": pack_client_rows(stack, state["seen"],
                                         self.trainer.layout)}

    def state_from_ckpt(self, ck, w_glob):
        state: Dict = {}
        if ck.get("prev"):
            if self._staged_store:
                arena, state["seen"] = unpack_client_rows(
                    ck["prev"], self.trainer.layout, self.fl.num_devices,
                    False)
                state["_host"] = {"prev": arena}
            else:
                state["prev"], state["seen"] = unpack_client_rows(
                    ck["prev"], self.trainer.layout, self.fl.num_devices,
                    w_glob.device)
        return state


class Scaffold(_Planner):
    """Karimireddy et al. 2020 — stochastic controlled averaging.

    ``state["c"]`` is the (P,) server control variate and ``state["ci"]``
    the (K + 1, P) client-variate stack (rows never trained are the zeros
    the algorithm starts c_i at; under a staged store a host (K, P)
    arena, ``state["_host"]["ci"]``, staged per block). Option II update for c_i:
    c_i+ = c_i - c + (w_glob - w_i) / (K_i * lr)."""
    variant = "scaffold"
    keep_locals = True
    _transfers_per_client = 2       # model + control variate each way
    _client_fields = ("ci",)
    _shared_fields = ("c",)

    def _plan_round(self, t, rng, state):
        ids = self._sample(rng)
        plans = tuple(self._batch_plan(i, rng) for i in ids)
        group = VisitGroup(
            hops=(Hop(tuple(ids), plans),), variant="scaffold",
            shared_extras={"c_glob": StateRef("c")},
            stacked_extras={"c_local": tuple(StateRef("ci", i)
                                             for i in ids)},
            agg=AggSpec.flat(self._weights(ids)), keep_locals=True)
        n = 2 * len(ids)                    # model + control variate
        return RoundPlan(groups=(group,),
                         comm=(("cloud_down", n), ("cloud_up", n)))

    def ensure_state(self, state, w_glob):
        if "c" in state:
            return
        state["c"] = torch.zeros_like(w_glob)
        if self._staged_store:
            state["_host"] = {"ci": host_stack(w_glob, self.fl.num_devices)}
        else:
            state["ci"] = client_stack(w_glob, self.fl.num_devices)
        state["seen"] = np.zeros(self.fl.num_devices + 1, bool)

    def update_state(self, plan, w_before, result, lr, state):
        grp = plan.groups[0]
        ids = np.asarray(grp.hops[0].ids)
        steps = np.asarray(grp.lane_steps())
        # K_i * lr per lane: the product in float64, rounded to float32 on
        # the host, as the fused block ships it
        kl = np.asarray([max(k, 1) * lr for k in steps], np.float32)
        # lanes that ran no step scatter to the dump row and are left out
        # of the server variate's mean and of the |S|/K fraction
        live = steps > 0
        n_live = int(live.sum())
        mw = np.where(live, np.float32(1.0 / n_live), np.float32(0.0))
        frac = np.float32(n_live / self.fl.num_devices)
        dev = self.trainer.device
        state["c"], state["ci"] = scaffold_step(
            state["c"], state["ci"], self._state_rows(state, ids, live),
            result.locals_, w_before, torch.from_numpy(kl).to(dev),
            torch.from_numpy(mw).to(dev), torch.tensor(frac, device=dev))
        state["seen"][ids[live]] = True

    def state_to_ckpt(self, state):
        if "c" not in state:
            return {}
        stack = state["_host"]["ci"] if "_host" in state else state["ci"]
        return {"c": dict(unravel(state["c"], self.trainer.layout)),
                "ci": pack_client_rows(stack, state["seen"],
                                       self.trainer.layout)}

    def state_from_ckpt(self, ck, w_glob):
        state: Dict = {}
        if "c" in ck:
            state["c"] = torch.from_numpy(np.concatenate(
                [np.asarray(ck["c"][k], np.float32).reshape(-1)
                 for k, _ in self.trainer.layout])).to(w_glob.device)
            if self._staged_store:
                arena, state["seen"] = unpack_client_rows(
                    ck.get("ci") or {}, self.trainer.layout,
                    self.fl.num_devices, False)
                state["_host"] = {"ci": arena}
            else:
                state["ci"], state["seen"] = unpack_client_rows(
                    ck.get("ci") or {}, self.trainer.layout,
                    self.fl.num_devices, w_glob.device)
        return state


def _ring_scenario_comm(self, plan, dropped):
    """Comm of a transformed ring plan (FedSR's and Ring's, one group whose
    lanes are rings): every ring still receives the broadcast, its
    survivors pass the model around a ring shrunk to them, and only a lane
    with a survivor uploads."""
    if not plan.groups:
        return plan.comm
    grp = plan.groups[0]
    R = self.fl.ring_rounds
    p2p, live_lanes = 0, 0
    for c in range(grp.lanes):
        members = {hop.ids[c] for hop in grp.hops
                   if hop.plans[c] is not None}
        if members:
            live_lanes += 1
            p2p += ring_lap_hops(len(members), R)
    return (("cloud_down", grp.lanes), ("p2p", p2p),
            ("cloud_up", live_lanes))


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

    _scenario_comm = _ring_scenario_comm


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

    def _scenario_comm(self, plan, dropped):
        """Per edge: the cloud still broadcasts, the edge exchanges R
        iterations with its surviving devices, and only an edge with a
        survivor uploads back."""
        if not plan.groups:
            return plan.comm
        grp = plan.groups[0]
        R = self.fl.ring_rounds
        comm = []
        for lanes in grp.agg.groups:
            live = sum(1 for c in lanes if grp.hops[0].plans[c] is not None)
            comm.append(("cloud_down", 1))
            if live:
                comm += [("edge_down", R * live), ("edge_up", R * live),
                         ("cloud_up", 1)]
        return tuple(comm)


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

    _scenario_comm = _ring_scenario_comm


class Centralized(_Planner):
    """Upper-bound reference: pooled-data SGD (the paper's "Centralized"
    rows). No schedule to plan — one visit of the pooled shard a round, no
    communication — so it bypasses the plan IR and trains through
    ``LocalTrainer.train`` directly, under every engine."""

    pipelinable = False

    def __init__(self, trainer, clients, fl):
        if fl.scenario.active or fl.adversary.active:
            raise ValueError(
                "algorithm='centralized' bypasses the RoundPlan IR — "
                "scenario and adversary transforms cannot apply to pooled "
                "SGD; disable them (scenario.frac=0, adversary.frac=0) "
                "for the centralized baseline")
        super().__init__(trainer, clients, fl)
        self.pool = ClientData(-1, np.concatenate([c.images for c in clients]),
                               np.concatenate([c.labels for c in clients]))

    def run_schedule(self, w_glob, t0, lrs, rng, meter, state):
        """A block is the per-round loop: each round one visit of the
        pool, its batch plan drawn from ``rng`` as the reference draws it;
        no comm to meter, and under DP-SGD the visit's steps charged to the
        ledger."""
        for lr in lrs:
            w_glob = self.trainer.train(w_glob, self.pool, lr=float(lr),
                                        epochs=self.fl.local_epochs, rng=rng)
            if self.privacy is not None:
                self.privacy.record(self.trainer.last_steps)
        return w_glob, state


ALGORITHMS = {"fedavg": FedAvg, "fedprox": FedProx, "moon": Moon,
              "hieravg": HierFAVG, "ring": RingOptimization, "fedsr": FedSR,
              "scaffold": Scaffold, "centralized": Centralized}


def make_algorithm(name: str, trainer: LocalTrainer,
                   clients: List[ClientData], fl: FLConfig):
    if name not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {name!r}")
    return ALGORITHMS[name](trainer, clients, fl)
