"""Fused engine: a whole block of rounds as ONE call (the port's twin of
the JAX package's ``core/engines/fused.py``, ``run_schedule`` path).

Client shards come from the engine's store (``data.store``): the fleet
uploaded once, or under ``store="host"``/``"stream"`` the block's cohort
arena, staged at the block boundary or prefetched while the previous
block runs. The plans of an eval-to-eval
block stack along a leading round axis — ghost lanes, all-invalid hops and
invalid steps pad rounds whose participation drew different shapes — into
int32/bool/f32 arrays that are the block's entire H2D payload, and
``LocalTrainer.train_schedule`` runs them. A block of single-group plans
stacks as a cohort (``_stack_cohort_schedule``, with MOON's and
SCAFFOLD's state lanes); a block of HierFAVG's chained edge iterations as
an iteration axis inside the round axis (``_stack_hier_schedule``). The
algorithm's device-resident state rides the block as its carry. A block
with an attacked round also ships the adversary's (n, C) delta factors
(``dscale``); an honest block ships none and runs the honest path. Under a
robust reducer (``AggSpec.reducer``) a cohort block ships the uncollapsed
lane weights and the group weights (``aggw``, ``aggg``) and a HierFAVG
block the cloud weights (``gwv``) in place of the collapsed ``aggv``.

``FLConfig.mesh_data_axis`` composes (the sim mesh, ``launch.mesh``): the
store's planes take the mesh layout (shards padded to the largest, rows
to a mesh multiple; ``DeviceDataPlane``), and every lane axis of the
block is ghost-padded to a mesh multiple (``_pad``): ghost lanes index
fleet row 0 under an all-invalid mask, weigh 0 in ``aggv``, ``aggw`` and
``wg``, seed from edge row 0, carry the delta factor 1.0, and under MOON
and SCAFFOLD point their ``ids`` at the dump row K of ``core.state``, so
the in-block state scatter discards them.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.engines.batched import BatchedEngine
from repro_torch.core.plan import Schedule
from repro_torch.data.pipeline import DeviceDataPlane, stack_plan_indices
from repro_torch.data.store import make_store


# the state fields each variant's block carries (``core.state``)
_CARRY = {"moon": ("prev",), "scaffold": ("c", "ci")}


class FusedEngine(BatchedEngine):

    def __init__(self, trainer, clients, fl):
        super().__init__(trainer, clients, fl)
        # where the fleet lives between blocks is the store's policy
        # (FLConfig.store): the upload-once fleet plane, or per-block
        # cohort arenas that keep device bytes O(cohort) (data.store)
        self.store = make_store(fl.store, clients, trainer.device,
                                mesh=self.mesh)
        self._arena: DeviceDataPlane = None

    @property
    def plane(self) -> DeviceDataPlane:
        """The data plane serving the current block, staged by
        ``stage_data``; before any staging the store serves the whole
        fleet."""
        if self._arena is None:
            self._arena = self.store.arena(None)
        return self._arena

    def stage_data(self, visited) -> int:
        """Block boundary of the residency protocol: ask the store for the
        arena covering ``visited`` and report its resident bytes. The
        device store serves the same fleet plane every block (its one-time
        upload is ``plane.nbytes``, not metered as per-block H2D); the
        host and stream stores upload the cohort, which is real H2D
        traffic and lands on the trainer's ``h2d_bytes``. A matching
        ``prefetch_data`` makes this call consume the arena staged in the
        background."""
        if visited is not None and len(visited) == 0:
            return 0        # ring_rounds=0: the block gathers nothing
        fresh = self.store.arena_nbytes(visited)
        if self.store.kind in ("host", "stream"):
            self.trainer.h2d_bytes += fresh
        self._arena = self.store.arena(visited)
        return self._arena.nbytes

    def prefetch_data(self, visited) -> None:
        """Hand the next block's cohort gather and upload to the store's
        staging thread while the current block runs."""
        if visited is not None and len(visited) == 0:
            return          # ring_rounds=0: nothing to stage
        self.store.prefetch(visited)

    def stage_pair_nbytes(self) -> int:
        return self.store.last_pair_nbytes

    def staging_stats(self):
        return self.store.stage_seconds, self.store.overlapped_stage_seconds

    def run_schedule(self, sched: Schedule, w_glob, lrs, state, update_fn):
        """The whole block as one ``train_schedule`` call. MOON's and
        SCAFFOLD's state rides the call as its carry, so ``update_fn`` is
        not called: the carry comes back into ``state`` after the call,
        and the host ``seen`` mask advances from the plans (no device
        readback)."""
        plans = sched.plans
        if not plans or not plans[0].groups:
            return w_glob       # ring_rounds=0: rounds leave w unchanged
        grp = plans[0].groups[0]
        xs = (self._stack_hier_schedule(plans, lrs)
              if len(plans[0].groups) > 1
              else self._stack_cohort_schedule(plans, lrs, grp.variant,
                                               state))
        carry = {f: state[f] for f in _CARRY.get(grp.variant, ())}
        agg = plans[0].groups[-1].agg
        w_glob, carry = self.trainer.train_schedule(
            w_glob, self.plane, xs, carry, variant=grp.variant,
            shared_extras=grp.shared_extras,
            stacked_extras=grp.stacked_extras, reducer=agg.reducer,
            trim_frac=agg.trim_frac, krum_f=agg.krum_f, mesh=self.mesh)
        if carry:
            state.update(carry)
            for plan in plans:
                g = plan.groups[0]
                live = np.asarray(g.lane_steps()) > 0
                state["seen"][np.asarray(g.hops[0].ids)[live]] = True
        return w_glob

    def _schedule_dims(self, groups):
        """(lane pad, hop pad, step pad, batch width) over a block's
        groups, so per-round shapes stack along one uniform round axis."""
        Cp = self._pad(max(g.lanes for g in groups))
        H = max(len(g.hops) for g in groups)
        S = max(p.shape[0] for g in groups for hop in g.hops
                for p in hop.plans if p is not None)
        B = next(p.shape[1] for g in groups for hop in g.hops
                 for p in hop.plans if p is not None)
        return Cp, H, S, B

    def _add_dscale(self, xs, groups, Cp: int) -> None:
        """Stack the adversary's per-lane delta factors as an (n, Cp) ``xs``
        lane when any round of the block is attacked (honest rounds and
        ghost lanes carry 1.0); an honest block ships nothing."""
        rows = [self._dscale(g, Cp) for g in groups]
        if any(r is not None for r in rows):
            xs["dscale"] = np.stack([np.ones(Cp, np.float32) if r is None
                                     else r for r in rows])

    def _stack_cohort_schedule(self, plans, lrs, variant: str = "plain",
                               state=None):
        """Stack a block of single-group plans along the round axis:
        ``rows``/``plans``/``valid`` index arrays, per-round ``lr`` and the
        collapsed eq.-11 weights ``aggv`` (ghost lanes weigh 0), or under a
        robust reducer the uncollapsed lane weights ``aggw`` (n, Gm, Cp)
        and group weights ``aggg`` (n, Gm), zero rows padding each round
        to the block's largest group count; for MOON
        and SCAFFOLD also the state-carry lanes: each lane's client row
        ``ids`` (a dead lane's: the dump row K), MOON's ``use_prev`` (from
        a copy of ``state["seen"]`` that advances round by round through
        the block) and SCAFFOLD's float32-rounded ``K_i * lr`` divisors
        ``kl``, mean weights ``mw`` and participation fractions ``frac``;
        under a staged store ``ids`` are cohort rows (``state["_rowmap"]``).
        Byte-identical to the reference's arrays."""
        K = self.fl.num_devices
        groups = [p.groups[0] for p in plans]
        n = len(groups)
        Cp, H, S, B = self._schedule_dims(groups)
        robust = groups[0].agg.reducer != "weighted_mean"
        rows = np.zeros((n, H, Cp), np.int32)
        idx = np.zeros((n, H, Cp, S, B), np.int32)
        valid = np.zeros((n, H, Cp, S), bool)
        aggv = np.zeros((n, Cp), np.float32)
        ids = np.full((n, Cp), K, np.int32)
        # a padded group row has no valid lane: a zero row at weight 0
        Gm = max(len(g.agg.groups) for g in groups)
        aggw = np.zeros((n, Gm, Cp), np.float32)
        aggg = np.zeros((n, Gm), np.float32)
        for r, g in enumerate(groups):
            for h, hop in enumerate(g.hops):
                rw, ix, vl = stack_plan_indices(
                    list(hop.plans), list(hop.ids), pad_to=Cp, steps=S,
                    width=B)
                rows[r, h], idx[r, h], valid[r, h] = rw, ix, vl
            # hops past len(g.hops) stay all-invalid: every lane carried
            # unchanged, exactly the ring-tail rule
            if robust:
                G = len(g.agg.groups)
                aggw[r, :G] = dataclasses.replace(
                    g.agg, group_weights=None).matrix(Cp)
                aggg[r, :G] = g.agg.group_weights
            else:
                aggv[r] = g.agg.matrix(Cp)
            live = np.asarray(g.lane_steps()) > 0
            ids[r, :g.lanes] = np.where(live, np.asarray(g.hops[0].ids), K)
        rowmap = state.get("_rowmap") if isinstance(state, dict) else None
        if rowmap is not None:
            # a staged store: the state carry is the block's (V + 1, P)
            # cohort stack, so fleet ids (and the fleet dump K) go through
            # the fleet->cohort table (the dump K to the staged dump V)
            ids = rowmap[ids]
        xs = {"rows": rows, "plans": idx, "valid": valid,
              "lr": np.asarray(lrs, np.float32)}
        xs.update({"aggw": aggw, "aggg": aggg} if robust else {"aggv": aggv})
        self._add_dscale(xs, groups, Cp)
        if variant == "moon":
            seen = np.asarray(state["seen"]).copy()
            use_prev = np.zeros((n, Cp), bool)
            for r, g in enumerate(groups):
                lane_ids = np.asarray(g.hops[0].ids)
                live = np.asarray(g.lane_steps()) > 0
                use_prev[r, :g.lanes] = seen[lane_ids]
                seen[lane_ids[live]] = True
            xs.update(ids=ids, use_prev=use_prev)
        elif variant == "scaffold":
            kl = np.ones((n, Cp), np.float32)
            mw = np.zeros((n, Cp), np.float32)
            frac = np.zeros(n, np.float32)
            for r, g in enumerate(groups):
                steps = np.asarray(g.lane_steps())
                live = steps > 0
                n_live = int(live.sum())
                # the product in float64, then rounded, as update_state
                kl[r, :g.lanes] = np.asarray(
                    [max(k, 1) * float(lrs[r]) for k in steps], np.float32)
                mw[r, :g.lanes] = np.where(live, np.float32(1.0 / n_live),
                                           np.float32(0.0))
                frac[r] = np.float32(n_live / K)
            xs.update(ids=ids, kl=kl, mw=mw, frac=frac)
        return xs

    def _stack_hier_schedule(self, plans, lrs):
        """Stack a block of HierFAVG plans: each round's R chained edge
        iterations become an iteration axis inside the round axis —
        ``rows``/``plans``/``valid`` (n, R, C, ...), per-round ``lr``, the
        uncollapsed (G, C) per-edge reduce ``wg`` applied after every
        iteration but the last, each lane's edge ``seed`` (n, C) and the
        collapsed cloud vector ``aggv`` of the last iteration, or under a
        robust reducer its (n, G) cloud weights ``gwv`` (the last
        iteration's lane validity is ``wg``'s)."""
        n = len(plans)
        R = len(plans[0].groups)
        groups = [g for p in plans for g in p.groups]
        Cp, _, S, B = self._schedule_dims(groups)
        G = len(plans[0].groups[0].agg.groups)
        rows = np.zeros((n, R, Cp), np.int32)
        idx = np.zeros((n, R, Cp, S, B), np.int32)
        valid = np.zeros((n, R, Cp, S), bool)
        wg = np.zeros((n, G, Cp), np.float32)
        seed = np.zeros((n, Cp), np.int32)
        robust = plans[0].groups[-1].agg.reducer != "weighted_mean"
        aggv = np.zeros((n, Cp), np.float32)
        gwv = np.zeros((n, G), np.float32)
        for r, plan in enumerate(plans):
            for it, g in enumerate(plan.groups):
                (hop,) = g.hops
                rows[r, it], idx[r, it], valid[r, it] = stack_plan_indices(
                    list(hop.plans), list(hop.ids), pad_to=Cp, steps=S,
                    width=B)
            first, last = plan.groups[0], plan.groups[-1]
            # ghost lanes weigh 0 in every row of wg and seed from row 0
            wg[r] = dataclasses.replace(
                first.agg, group_weights=None).matrix(Cp)
            if robust:
                gwv[r] = last.agg.group_weights
            else:
                aggv[r] = last.agg.matrix(Cp)
            seed[r, :last.lanes] = last.seed
        xs = {"rows": rows, "plans": idx, "valid": valid,
              "lr": np.asarray(lrs, np.float32), "wg": wg, "seed": seed}
        xs.update({"gwv": gwv} if robust else {"aggv": aggv})
        # every iteration of a round carries its first group's factors
        self._add_dscale(xs, [p.groups[0] for p in plans], Cp)
        return xs
