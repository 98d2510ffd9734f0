"""Star-ring topology management (paper §III-C).

Devices select a nearby edge server (simulated: uniform assignment); each
round the edge server samples its participating devices and connects them
into a random ring (Algorithm 1). Same draws as the JAX package.
"""
from __future__ import annotations

from typing import List

import numpy as np


def assign_edges(num_devices: int, num_edges: int) -> List[List[int]]:
    """Uniform device->edge assignment (paper §IV-C)."""
    if num_edges <= 0 or num_devices % num_edges != 0:
        raise ValueError(
            f"num_edges={num_edges} must divide num_devices={num_devices} "
            "evenly (every edge server gets the same device count)")
    per = num_devices // num_edges
    return [list(range(m * per, (m + 1) * per)) for m in range(num_edges)]


def sample_ring(
    edge_devices: List[int],
    rng: np.random.Generator,
    *,
    participation: float = 1.0,
    reshuffle: bool = True,
) -> List[int]:
    """Sample this round's participants of one edge and ring-order them."""
    n = max(1, int(round(len(edge_devices) * participation)))
    chosen = rng.choice(len(edge_devices), size=n, replace=False)
    ring = [edge_devices[i] for i in chosen]
    if reshuffle:
        rng.shuffle(ring)
    else:
        ring.sort()
    return ring


def clusters_of(
    participants: List[int], cluster_size: int, rng: np.random.Generator
) -> List[List[int]]:
    """Group sampled participants into rings of ``cluster_size`` (Table IV)."""
    participants = list(participants)
    rng.shuffle(participants)
    return [
        participants[i : i + cluster_size]
        for i in range(0, len(participants), cluster_size)
    ]
