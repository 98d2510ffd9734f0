"""Plain PyTorch version of the lane-stacked fused SGD update — the
function ``csrc/fused_sgd.cu`` computes, in the same elementwise order.
The CPU runs it in place of the kernel; on the card it is what the kernel
is held against, bit for bit."""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

Grads = Union[torch.Tensor, Sequence[torch.Tensor]]


def flat_grads(grads: Grads, lanes: int) -> torch.Tensor:
    """The (C, P) gradient of a leaf list: its (C, size_k) leaves side by
    side in list order (a (C, P) tensor is returned as it is)."""
    if isinstance(grads, torch.Tensor):
        return grads
    return torch.cat([g.reshape(lanes, -1) for g in grads], dim=1)


def sgd_lanes_reference(p: torch.Tensor, grads: Grads, m: torch.Tensor,
                        ok: torch.Tensor, lr: torch.Tensor, *, reset: bool,
                        momentum: float, nesterov: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One masked momentum step over a (C, P) lane stack; returns new
    (p, m). ``grads`` is the (C, P) gradient or its leaf list (see
    ``flat_grads``); ``ok`` (C,) bool selects the lanes that step;
    ``reset`` zeroes the momentum first (a client visit starts), for every
    lane."""
    g = flat_grads(grads, p.shape[0])
    m_in = torch.zeros_like(m) if reset else m
    m_new = momentum * m_in + g
    d = g + momentum * m_new if nesterov else m_new
    p_new = p - lr * d
    keep = ok.view(-1, 1)
    return torch.where(keep, p_new, p), torch.where(keep, m_new, m_in)
