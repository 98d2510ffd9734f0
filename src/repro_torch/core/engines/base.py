"""Shared engine plumbing (the port's twin of the JAX package's
``core/engines/base.py``): what every plan interpreter holds, and the
residency hooks the block runner calls. The per-round reference loop
(``Engine.run``) belongs to the sequential and batched engines, ROADMAP A5.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import FLConfig


class Engine:
    """Base plan interpreter. Engines never touch the comm meter (the
    executor applies ``plan.comm``) and never draw from the RNG stream
    (planners pre-draw every batch plan)."""

    def __init__(self, trainer, clients: List, fl: FLConfig):
        self.trainer = trainer
        self.clients = clients
        self.fl = fl

    def stage_data(self, visited) -> int:
        """Make the block's data resident; returns the resident bytes."""
        return 0

    def staging_stats(self):
        """(stage_seconds, overlapped_stage_seconds) of the engine's store."""
        return 0.0, 0.0

    def run_schedule(self, sched, w_glob, lrs):
        raise NotImplementedError
