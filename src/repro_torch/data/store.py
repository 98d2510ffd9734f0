"""Client stores — where the fleet's shards live between rounds.

Only the device store is ported: the whole fleet uploads once as one
``DeviceDataPlane`` and every block reuses it. The host and stream stores
(per-block cohort arenas, prefetch) are ROADMAP A6.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.data.pipeline import ClientData, DeviceDataPlane


class DeviceStore:
    """Upload the whole fleet once; every block reuses the same plane."""

    def __init__(self, clients: List[ClientData], device: torch.device):
        self.clients = list(clients)
        self.device = device
        self.stage_seconds = 0.0            # the one upload's wall time
        self.overlapped_stage_seconds = 0.0  # no prefetch: always 0
        self._plane: Optional[DeviceDataPlane] = None

    def arena(self, visited: Optional[np.ndarray] = None) -> DeviceDataPlane:
        if self._plane is None:
            t0 = time.perf_counter()
            self._plane = DeviceDataPlane(self.clients, self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stage_seconds += time.perf_counter() - t0
        return self._plane


def make_store(name: str, clients: List[ClientData],
               device: torch.device) -> DeviceStore:
    """Build the residency policy selected by ``FLConfig.store``."""
    if name in ("host", "stream"):
        raise NotImplementedError(
            f"FLConfig.store={name!r} is not ported yet (ROADMAP A6)")
    if name != "device":
        raise ValueError(f"unknown FLConfig.store {name!r}; "
                         "expected 'device', 'host' or 'stream'")
    return DeviceStore(clients, device)
