"""Communication accounting (paper Table III), device residency and the
staging pipeline's timing.

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
    algorithm state, recorded once per schedule block by the block runner;
    under the staged stores they scale with the cohort, never with K.

    Under the prefetch pipeline (``FLConfig.prefetch=1``) block ``t``'s
    arena and staged state and block ``t + 1``'s double-buffered arena
    (and its eagerly staged state rows, when the visited sets are
    disjoint) are live at once; ``record_transient`` folds that high-water
    mark into ``peak_bytes`` without touching the per-block fields, so
    ``peak_bytes`` stays within twice one cohort's arena and state.

    Also the pipeline's timing: ``stage_seconds`` (the staging wall),
    ``overlapped_stage_seconds`` (the part served from a prefetch, hidden
    behind a running block) and ``dispatch_seconds`` (from each block's
    dispatch to its eval's fence); ``overlap_fraction`` is the share of
    the staging wall the prefetch hid."""

    data_bytes: int = 0     # latest block's data arena
    state_bytes: int = 0    # latest block's staged state rows
    peak_bytes: int = 0     # max over blocks of data + state, double-
                            # buffered windows included
    stage_seconds: float = 0.0              # total staging wall
    overlapped_stage_seconds: float = 0.0   # staging wall hidden by prefetch
    dispatch_seconds: float = 0.0           # dispatch-to-fence wall

    def record(self, data_bytes: int, state_bytes: int) -> None:
        self.data_bytes = int(data_bytes)
        self.state_bytes = int(state_bytes)
        self.peak_bytes = max(self.peak_bytes,
                              self.data_bytes + self.state_bytes)

    def record_transient(self, nbytes: int) -> None:
        """A momentary high-water mark (both pipeline buffers live): it
        raises ``peak_bytes`` only."""
        self.peak_bytes = max(self.peak_bytes, int(nbytes))

    def record_stage(self, seconds: float, overlapped: bool = False) -> None:
        self.stage_seconds += float(seconds)
        if overlapped:
            self.overlapped_stage_seconds += float(seconds)

    def record_dispatch(self, seconds: float) -> None:
        self.dispatch_seconds += float(seconds)

    @property
    def overlap_fraction(self) -> float:
        """The share of the staging wall that ran behind a running block
        (0.0 when nothing was staged)."""
        if self.stage_seconds <= 0.0:
            return 0.0
        return self.overlapped_stage_seconds / self.stage_seconds

    def snapshot(self) -> Dict[str, float]:
        return {"data_bytes": self.data_bytes,
                "state_bytes": self.state_bytes,
                "peak_bytes": self.peak_bytes,
                "stage_seconds": self.stage_seconds,
                "overlapped_stage_seconds": self.overlapped_stage_seconds,
                "dispatch_seconds": self.dispatch_seconds,
                "overlap_fraction": self.overlap_fraction}
