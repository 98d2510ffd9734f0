"""The reference engine: a Python loop of single-client steps (the port's
twin of the JAX package's ``core/engines/sequential.py``).

Interprets a RoundPlan literally — every lane of a group is an independent
chain of ``LocalTrainer.train`` calls over the pre-drawn batch plans, with
its own per-lane extras (MOON's ``w_prev``, SCAFFOLD's ``c_local``),
aggregated in the reference's order by ``utils.tree.weighted_sum`` (the
paper-faithful semantics every other engine must reproduce). Lanes are
independent given their plans, so training lane by lane is exactly
Algorithm 1's device-by-device schedule; the planner already drew the RNG
stream in this visit order.

An attacked group (``lane_scale``, ``core.adversary``) transforms each
trained lane against its seed, lane by lane in the reference's order,
before the reduce. The reduce is the two-level sum of eq. 11 (each
group's lanes weighted in lane order, then the groups), not the batched
and fused engines' folded ``aggv @ lanes``: both are eq. 11 but round
differently, so this engine agrees with the others within f32 rounding,
not bit for bit. An
uncollapsed group (HierFAVG's intermediate edge iterations) returns its G
group models, and lane c of the next group starts from model
``seed[c]``. A robust reducer (``AggSpec.reducer``) stacks the lanes and
takes ``core.robust``'s statistic over each group's valid lanes, as the
other engines do.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engines.base import Engine
from repro_torch.core.robust import robust_agg
from repro_torch.utils.tree import weighted_sum


class SequentialEngine(Engine):

    def _run_group(self, grp, w_glob, prev, lr, state):
        kw = self._loss_kwargs(grp, w_glob, state)
        lanes = []
        for c in range(grp.lanes):
            lane_kw = dict(kw, **{k: self._resolve(refs[c], w_glob, state)
                                  for k, refs in grp.stacked_extras.items()})
            w = w_glob if grp.seed is None else prev[grp.seed[c]]
            for hop in grp.hops:
                if hop.plans[c] is None:        # ring tail: carried unchanged
                    continue
                w = self.trainer.train(w, self.clients[hop.ids[c]], lr=lr,
                                       plan=hop.plans[c], **lane_kw)
            lanes.append(w)
        if grp.lane_scale is not None:
            # a Byzantine upload: lane c hands back ref + t * (model - ref)
            # against its seed, as the other engines do before the reduce
            for c, t in enumerate(grp.lane_scale):
                if t == 1.0:
                    continue
                ref = w_glob if grp.seed is None else prev[grp.seed[c]]
                lanes[c] = ref + t * (lanes[c] - ref)
        agg = grp.agg
        if agg.reducer != "weighted_mean":
            wm = dataclasses.replace(agg, group_weights=None).matrix(
                grp.lanes)
            gw = (np.asarray(agg.group_weights, np.float32)
                  if agg.collapsed else None)
            red = robust_agg(torch.stack(lanes), wm, gw, agg.reducer,
                             agg.trim_frac, agg.krum_f)
            return (red if agg.collapsed else list(red)), lanes
        groups = [weighted_sum([lanes[la] for la in members],
                               [agg.lane_weights[la] for la in members])
                  for members in agg.groups]
        if not agg.collapsed:
            return groups, lanes
        return weighted_sum(groups, agg.group_weights), lanes
