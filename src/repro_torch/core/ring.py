"""Ring-optimization hop accounting (paper §III-B, eq. 6-7)."""
from __future__ import annotations


def ring_lap_hops(size: int, laps: int) -> int:
    """Closed-form p2p hop count of ``laps`` laps over a ``size``-device
    ring: size-1 forward hops per lap plus ONE lap-closing hop back to the
    first device between consecutive laps — ``laps*(size-1) + (laps-1)``
    total. A single-device ring and zero laps both make 0 hops."""
    if size <= 1 or laps <= 0:
        return 0
    return laps * (size - 1) + (laps - 1)
