"""Batched engine: concurrent visits as one call (the port's twin of the
JAX package's ``core/engines/batched.py``).

Each hop of a visit group — a whole star cohort, or position j of every
ring in lockstep — runs as ONE ``LocalTrainer.train_many`` call over the
(C, P) lane stack, with host-built padded batch stacks and a (C, S)
valid-step mask (``stack_plans``) that cross H2D every hop. A star cohort
of one hop starts every lane from the global model (``broadcast``); a ring
group carries the lane stack from hop to hop. The group's last call folds
the eq.-11 weighted reduce in (``agg=``).

The fused engine inherits ``_pad``. Its mesh-sharded form
(``engine="sharded"``, ghost lanes up to a mesh multiple) is ROADMAP A5;
on one GPU no mesh exists, so lane padding is the identity.
"""
from __future__ import annotations

from repro_torch.core.engines.base import Engine
from repro_torch.core.plan import Hop
from repro_torch.data.pipeline import stack_plans


class BatchedEngine(Engine):

    def _pad(self, c: int) -> int:
        """Round a lane count up to the mesh size (ghost-lane padding of
        the sharded engine); identity with no mesh."""
        return c

    def _run_group(self, grp, w_glob, lr):
        padded = self._pad(grp.lanes)
        agg = grp.agg.matrix(padded)
        hops = grp.hops
        # the group-wide batch width: a single hop can hold only None plans
        B = next(p.shape[1] for h in hops for p in h.plans if p is not None)
        if len(hops) == 1:
            # star cohort: every lane starts from the global model
            return self._train_hop(hops[0], padded, B, w_glob, lr,
                                   broadcast=True, agg=agg)
        # ring lap sequence: carry the lane stack hop to hop; the LAST
        # hop's call folds the reduce
        models = w_glob.unsqueeze(0).expand(padded, -1).contiguous()
        for j, hop in enumerate(hops):
            last = j == len(hops) - 1
            models = self._train_hop(hop, padded, B, models, lr,
                                     agg=agg if last else None)
        return models

    def _train_hop(self, hop: Hop, padded: int, width: int, params, lr,
                   **kw):
        batches, valid = stack_plans(
            [self.clients[i] for i in hop.ids], list(hop.plans),
            pad_to=padded, width=width)
        return self.trainer.train_many(params, batches, valid, lr=lr, **kw)
