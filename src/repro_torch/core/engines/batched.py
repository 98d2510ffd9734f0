"""The parts of the batched engine that the fused engine inherits.

The batched engine itself (host-fed batch stacks, one dispatch per hop)
and its mesh-sharded form are ROADMAP A5; on one GPU no mesh exists, so
lane padding is the identity.
"""
from __future__ import annotations

from repro_torch.core.engines.base import Engine


class BatchedEngine(Engine):

    def _pad(self, c: int) -> int:
        """Round a lane count up to the mesh size (ghost-lane padding of
        the sharded engine); identity with no mesh."""
        return c
