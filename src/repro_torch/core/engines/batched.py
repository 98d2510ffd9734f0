"""Batched engine: concurrent visits as one call (the port's twin of the
JAX package's ``core/engines/batched.py``).

Each hop of a visit group — a whole star cohort, or position j of every
ring in lockstep — runs as ONE ``LocalTrainer.train_many`` call over the
(C, P) lane stack, with host-built padded batch stacks and a (C, S)
valid-step mask (``stack_plans``) that cross H2D every hop. A star cohort
of one hop starts every lane from the global model (``broadcast``); a ring
group carries the lane stack from hop to hop; a seeded group (HierFAVG's
edge iterations) starts from a fresh stack of the previous group's edge
models. The group's last call folds the reduce in (``agg=``): the eq.-11
weighted cloud reduce, or the (G, C) per-edge reduce of an uncollapsed
group, or under a robust reducer its order statistic over each group's
valid lanes (``AggSpec.reduce_kwargs``); with ``keep_locals`` it returns
the trained lanes too. An attacked
group's ``lane_scale`` rides the same call (``dscale``), against the
lanes' seed: the global model for a cohort or a ring, each lane's edge
model for a seeded group. Per-lane
extras (MOON's ``w_prev``, SCAFFOLD's ``c_local``) are stacked along the
lane axis on the device.

This engine is host-fed, so a staged store (``FLConfig.store="host"`` or
``"stream"``) changes nothing of its data path; MOON's and SCAFFOLD's rows
arrive as the block's staged cohort carry, read through ``_resolve``'s
row map.

``engine="sharded"`` is this engine on the sim mesh
(``launch.mesh.make_sim_mesh``), and ``FLConfig.mesh_data_axis`` opts the
plain batched and fused engines into it: every lane stack is ghost-padded
to the next multiple of the mesh size (``_pad``, which the fused engine
inherits). A ghost lane is an ordinary lane whose steps are all invalid:
zero data, the global model as its seed and extras, row 0 of a seeded
group's edge models, the honest delta factor 1.0 and weight 0 in every
reduce, so it never trains, draws no RNG and moves no aggregate. With
every mesh entry the trainer's one device the lanes stay where they are;
a mesh over several distinct devices raises (ROADMAP A5.2).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engines.base import Engine
from repro_torch.core.plan import Hop
from repro_torch.data.pipeline import stack_plans
from repro_torch.launch.mesh import make_sim_mesh, round_up_to_mesh


class BatchedEngine(Engine):

    def __init__(self, trainer, clients, fl):
        super().__init__(trainer, clients, fl)
        if fl.engine == "sharded" or fl.mesh_data_axis:
            self.mesh = make_sim_mesh(fl.num_devices, axis=self.data_axis,
                                      device=trainer.device)

    def _pad(self, c: int) -> int:
        """Round a lane count up to the mesh size (ghost-lane padding of
        the sharded engine); identity with no mesh."""
        if self.mesh is None:
            return c
        return round_up_to_mesh(c, self.mesh)

    def _seed_stack(self, prev: torch.Tensor, seed, padded: int):
        """A fresh (padded, P) stack of each lane's seed row of the previous
        group's (G, P) aggregate; ghost lanes reuse row 0 (weight 0, never
        trained)."""
        idx = torch.tensor(list(seed) + [0] * (padded - len(seed)),
                           device=prev.device)
        return torch.index_select(prev, 0, idx)

    def _extras_kwargs(self, grp, w_glob, padded: int, state) -> dict:
        """The group's loss variant and extras for ``train_many``: shared
        ones resolved as they are, per-lane ones stacked along the lane
        axis (ghost lanes padded with the global model; they never
        train)."""
        kw = self._loss_kwargs(grp, w_glob, state)
        for k, refs in grp.stacked_extras.items():
            rows = [self._resolve(v, w_glob, state) for v in refs]
            kw[k] = torch.stack(rows + [w_glob] * (padded - len(rows)))
        return kw

    @staticmethod
    def _dscale(grp, padded: int):
        """The adversary's per-lane delta factors, ghost lanes padded with
        the honest 1.0; None for an honest group."""
        if grp.lane_scale is None:
            return None
        ds = np.ones(padded, np.float32)
        ds[:grp.lanes] = grp.lane_scale
        return ds

    def _run_group(self, grp, w_glob, prev, lr, state):
        padded = self._pad(grp.lanes)
        red = dict(grp.agg.reduce_kwargs(padded),
                   keep_locals=grp.keep_locals,
                   dscale=self._dscale(grp, padded))
        kw = self._extras_kwargs(grp, w_glob, padded, state)
        keep = grp.keep_locals
        hops = grp.hops
        # the group-wide batch width: a single hop can hold only None plans
        B = next(p.shape[1] for h in hops for p in h.plans if p is not None)
        if grp.seed is None and len(hops) == 1:
            # star cohort: every lane starts from the global model
            out = self._train_hop(hops[0], padded, B, w_glob, lr,
                                  broadcast=True, **red, **kw)
            return out if keep else (out, None)
        # ring lap sequence / seeded edge iteration: carry the lane stack
        # hop to hop; the LAST hop's call folds the reduce
        # repeat copies even one lane: the steps train the stack in place
        models = (w_glob.repeat(padded, 1) if grp.seed is None
                  else self._seed_stack(prev, grp.seed, padded))
        if grp.seed is None and red["dscale"] is not None:
            # the last hop trains the mid-ring stack, not the lanes' seed:
            # the delta transform needs the broadcast global as its ref
            red["dref"] = w_glob
        for hop in hops[:-1]:
            models = self._train_hop(hop, padded, B, models, lr, **kw)
        out = self._train_hop(hops[-1], padded, B, models, lr, **red, **kw)
        return out if keep else (out, None)

    def _train_hop(self, hop: Hop, padded: int, width: int, params, lr,
                   **kw):
        batches, valid = stack_plans(
            [self.clients[i] for i in hop.ids], list(hop.plans),
            pad_to=padded, width=width)
        return self.trainer.train_many(params, batches, valid, lr=lr,
                                       mesh=self.mesh, **kw)
