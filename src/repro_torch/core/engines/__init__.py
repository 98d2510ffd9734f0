"""Execution engines: interpreters of the RoundPlan IR (``core.plan``).

Only the fused engine is ported: a whole eval-to-eval block of rounds is
one ``LocalTrainer.train_schedule`` call against a device-resident data
plane. The sequential, batched and sharded engines are ROADMAP A5.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import FLConfig
from repro_torch.core.engines.fused import FusedEngine

ENGINES = {"fused": FusedEngine}


def make_engine(trainer, clients: List, fl: FLConfig):
    """Build the plan interpreter selected by ``FLConfig.engine``."""
    if fl.engine in ("sequential", "batched", "sharded"):
        raise NotImplementedError(
            f"engine {fl.engine!r} is not ported yet (ROADMAP A5); "
            "use engine='fused'")
    if fl.mesh_data_axis:
        raise NotImplementedError(
            "mesh_data_axis (the sharded placement) is not ported yet "
            "(ROADMAP A5)")
    if fl.engine not in ENGINES:
        raise ValueError(
            f"unknown FLConfig.engine {fl.engine!r}; "
            "expected 'sequential', 'batched', 'sharded' or 'fused'")
    return ENGINES[fl.engine](trainer, clients, fl)
