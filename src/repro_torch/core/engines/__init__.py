"""Execution engines: interpreters of the RoundPlan IR (``core.plan``).

Every engine consumes the identical pre-drawn plans, so they agree:

* ``sequential`` — the reference: one client visit at a time through
  ``LocalTrainer.train``, one step a dispatch, aggregated in the
  reference's order (the default, as in the JAX package);
* ``batched`` — every hop of concurrent visits as one
  ``LocalTrainer.train_many`` call over host-built batch stacks;
* ``fused`` — a whole eval-to-eval block of rounds as one
  ``LocalTrainer.train_schedule`` call against a device-resident data
  plane.

``sharded`` (the batched engine on a device mesh) and ``mesh_data_axis``
are ROADMAP A5: one GPU has no mesh.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import FLConfig
from repro_torch.core.engines.batched import BatchedEngine
from repro_torch.core.engines.fused import FusedEngine
from repro_torch.core.engines.sequential import SequentialEngine

ENGINES = {"sequential": SequentialEngine, "batched": BatchedEngine,
           "fused": FusedEngine}


def make_engine(trainer, clients: List, fl: FLConfig):
    """Build the plan interpreter selected by ``FLConfig.engine``."""
    if fl.engine == "sharded":
        raise NotImplementedError(
            "engine 'sharded' (the batched engine on a device mesh) is not "
            "ported yet (ROADMAP A5); use 'sequential', 'batched' or "
            "'fused'")
    if fl.mesh_data_axis:
        raise NotImplementedError(
            "mesh_data_axis (the sharded placement) is not ported yet "
            "(ROADMAP A5)")
    if fl.engine not in ENGINES:
        raise ValueError(
            f"unknown FLConfig.engine {fl.engine!r}; "
            "expected 'sequential', 'batched', 'sharded' or 'fused'")
    return ENGINES[fl.engine](trainer, clients, fl)
