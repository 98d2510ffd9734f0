"""Execution engines: interpreters of the RoundPlan IR (``core.plan``).

Every engine consumes the identical pre-drawn plans, so they agree:

* ``sequential`` — the reference: one client visit at a time through
  ``LocalTrainer.train``, one step a dispatch, aggregated in the
  reference's order (the default, as in the JAX package);
* ``batched`` — every hop of concurrent visits as one
  ``LocalTrainer.train_many`` call over host-built batch stacks;
* ``sharded`` — the batched engine on the sim mesh
  (``launch.mesh.make_sim_mesh``): every lane stack ghost-padded to a
  multiple of the mesh size; ghost lanes never train, never draw RNG and
  weigh 0 in every reduce;
* ``fused`` — a whole eval-to-eval block of rounds as one
  ``LocalTrainer.train_schedule`` call against a device-resident data
  plane. ``FLConfig.mesh_data_axis`` composes with it (and with
  ``batched``): the mesh's ghost lanes, and under the fused engine the
  mesh-padded data plane.

The sim mesh spans the visible devices, capped at the fleet size; on one
card it has one entry and the padding is the identity. A mesh over
several distinct devices raises ``NotImplementedError`` (ROADMAP A5.2).
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import FLConfig
from repro_torch.core.engines.batched import BatchedEngine
from repro_torch.core.engines.fused import FusedEngine
from repro_torch.core.engines.sequential import SequentialEngine

ENGINES = {
    "sequential": SequentialEngine,
    "batched": BatchedEngine,
    "sharded": BatchedEngine,       # = batched + mesh (see BatchedEngine)
    "fused": FusedEngine,
}


def make_engine(trainer, clients: List, fl: FLConfig):
    """Build the plan interpreter selected by ``FLConfig.engine``."""
    if fl.engine not in ENGINES:
        raise ValueError(
            f"unknown FLConfig.engine {fl.engine!r}; "
            "expected 'sequential', 'batched', 'sharded' or 'fused'")
    return ENGINES[fl.engine](trainer, clients, fl)
