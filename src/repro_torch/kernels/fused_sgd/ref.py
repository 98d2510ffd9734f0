"""Plain PyTorch version of the lane-stacked fused SGD update — the
function ``csrc/fused_sgd.cu`` computes, in the same elementwise order.
The CPU runs it in place of the kernel; on the card it is what the kernel
is held against, bit for bit.

In bfloat16 it rounds as the reference's Pallas kernel does at
``p.dtype = bfloat16``: to bfloat16 after every operation, each computed
in float32, with mu rounded to bfloat16 (the reference multiplies by a
weakly typed Python float) and lr read at bfloat16. PyTorch keeps a
Python scalar times a bfloat16 tensor in float32, so the rounding is
written out here."""
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


def bf16_value(x: float) -> float:
    """``x`` rounded to the nearest bfloat16, as a Python float."""
    return float(torch.tensor(x, dtype=torch.float32).to(torch.bfloat16))


def _round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to bfloat16, kept in float32."""
    return x.to(torch.bfloat16).float()


def _step_bf16(p, g, m_in, lr, momentum: float, nesterov: bool):
    """The bfloat16 update, every operation rounded (see the module's
    docstring); returns bfloat16 (p', m')."""
    mu = bf16_value(momentum)
    g, lr = g.float(), lr.float()
    m_new = _round(_round(mu * m_in.float()) + g)
    d = _round(g + _round(mu * m_new)) if nesterov else m_new
    p_new = _round(p.float() - _round(lr * d))
    return p_new.to(torch.bfloat16), m_new.to(torch.bfloat16)


def sgd_lanes_reference(p: torch.Tensor, grads: Grads, m: torch.Tensor,
                        ok: torch.Tensor, lr: torch.Tensor, *, reset: bool,
                        momentum: float, nesterov: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One masked momentum step over a (C, P) lane stack; returns new
    (p, m). ``grads`` is the (C, P) gradient or its leaf list (see
    ``flat_grads``); ``ok`` (C,) bool selects the lanes that step;
    ``reset`` zeroes the momentum first (a client visit starts), for every
    lane. A bfloat16 set (p, m, grads, lr) rounds after every operation."""
    g = flat_grads(grads, p.shape[0])
    m_in = torch.zeros_like(m) if reset else m
    if p.dtype == torch.bfloat16:
        p_new, m_new = _step_bf16(p, g, m_in, lr, momentum, nesterov)
    else:
        m_new = momentum * m_in + g
        d = g + momentum * m_new if nesterov else m_new
        p_new = p - lr * d
    keep = ok.view(-1, 1)
    return torch.where(keep, p_new, p), torch.where(keep, m_new, m_in)
