"""ring-optimization (paper §III-B, eq. 6-7) — the incremental subgradient
pass over a ring of clients: the twin of the JAX package's
``core/ring.py``. ``ring_optimization`` is Algorithm 1's inner loop as
written, one client visit at a time (``LocalTrainer.train``); the engines
run the same chain from the planners' plans, and ``ring_lap_hops`` is the
p2p count they meter.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.comm import CommMeter
from repro_torch.core.local import LocalTrainer


def ring_lap_hops(size: int, laps: int) -> int:
    """Closed-form p2p hop count of ``laps`` laps over a ``size``-device
    ring: size-1 forward hops per lap plus ONE lap-closing hop back to the
    first device between consecutive laps — ``laps*(size-1) + (laps-1)``
    total. A single-device ring and zero laps both make 0 hops."""
    if size <= 1 or laps <= 0:
        return 0
    return laps * (size - 1) + (laps - 1)


def ring_optimization(
    trainer: LocalTrainer,
    w: torch.Tensor,
    ring: Sequence,                 # ordered ClientData of this ring
    *,
    lr: float,
    laps: int,                      # R in Algorithm 1
    local_epochs: int,              # E
    rng: np.random.Generator,
    meter: Optional[CommMeter] = None,
) -> torch.Tensor:
    """Algorithm 1's inner loop: the flat (P,) model ``w`` hops device to
    device, each visit ``local_epochs`` SGD epochs on that device's shard
    (``trainer.train``, whose plans draw from ``rng`` in the reference's
    order). Each hop to the next device, and the lap-closing hop between
    laps, is one ``p2p`` record: R laps cost ``ring_lap_hops(K, R)``.
    Returns the last device's model (eq. 7: w_{t+1} = z_t^{P_K}); ``w`` is
    left as it was."""
    for lap in range(laps):
        for i, client in enumerate(ring):
            w = trainer.train(w, client, lr=lr, epochs=local_epochs, rng=rng)
            if meter is not None and i < len(ring) - 1:
                meter.record("p2p")     # hop to the next device
        # the last device sends back to the first only when another lap
        # follows; after the final lap the model goes up to the edge
        if meter is not None and lap < laps - 1 and len(ring) > 1:
            meter.record("p2p")
    return w
