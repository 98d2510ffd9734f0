"""Communication accounting (paper Table III) and device residency.

Transfers are counted in units of one full model, per channel, exactly as
the JAX package's ``core/comm.py`` counts them; ``sim_seconds`` is the
simulated clock the planner stamps on every round.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class CommMeter:
    model_bytes: int = 0
    cloud_up: int = 0       # edge/device -> cloud
    cloud_down: int = 0     # cloud -> edge/device
    edge_up: int = 0        # device -> edge server
    edge_down: int = 0      # edge server -> device
    p2p: int = 0            # device -> device (ring hop)
    sim_seconds: float = 0.0

    def record(self, channel: str, count: int = 1) -> None:
        setattr(self, channel, getattr(self, channel) + count)

    def record_time(self, seconds: float) -> None:
        self.sim_seconds += seconds

    @property
    def total_transfers(self) -> int:
        return (self.cloud_up + self.cloud_down + self.edge_up
                + self.edge_down + self.p2p)

    @property
    def cloud_transfers(self) -> int:
        return self.cloud_up + self.cloud_down

    @property
    def total_bytes(self) -> int:
        return self.total_transfers * self.model_bytes

    def snapshot(self) -> Dict[str, float]:
        return {
            "total_transfers": self.total_transfers,
            "cloud_transfers": self.cloud_transfers,
            "p2p_transfers": self.p2p,
            "edge_transfers": self.edge_up + self.edge_down,
            "total_bytes": self.total_bytes,
            "sim_seconds": self.sim_seconds,
        }


@dataclasses.dataclass
class ResidencyMeter:
    """Peak device-resident bytes of the client data plane plus staged
    algorithm state, recorded once per schedule block, and the dispatch
    wall of the blocks. The transient (double-buffer), staging and overlap
    fields of the reference belong to the prefetch pipeline (ROADMAP A6)."""

    data_bytes: int = 0
    state_bytes: int = 0
    peak_bytes: int = 0
    dispatch_seconds: float = 0.0

    def record(self, data_bytes: int, state_bytes: int) -> None:
        self.data_bytes = int(data_bytes)
        self.state_bytes = int(state_bytes)
        self.peak_bytes = max(self.peak_bytes,
                              self.data_bytes + self.state_bytes)

    def record_dispatch(self, seconds: float) -> None:
        self.dispatch_seconds += float(seconds)
