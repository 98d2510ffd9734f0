"""Public wrapper of the lane-stacked fused SGD update.

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/fused_sgd.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.py``). There is no fallback from the one to the other.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels.fused_sgd.ref import Grads, sgd_lanes_reference

MAX_LEAVES = 16     # the kernel's by-value leaf table


def _leaves(grads: Grads) -> Tuple[torch.Tensor, ...]:
    return (grads,) if isinstance(grads, torch.Tensor) else tuple(grads)


def _check(p, leaves, m, ok, lr) -> None:
    for name, t in (("m", m), ("ok", ok), ("lr", lr)) + tuple(
            (f"grads[{k}]", g) for k, g in enumerate(leaves)):
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"p must be float32 or bfloat16, got {p.dtype}")
    for name, t in (("m", m), ("lr", lr)) + tuple(
            (f"grads[{k}]", g) for k, g in enumerate(leaves)):
        if t.dtype != p.dtype:
            raise TypeError(f"{name} must be {p.dtype} as p is, got "
                            f"{t.dtype}")
    if ok.dtype != torch.bool:
        raise TypeError(f"ok must be bool, got {ok.dtype}")
    if p.dim() != 2 or m.shape != p.shape:
        raise ValueError(f"p and m must share one (C, P) shape: "
                         f"{tuple(p.shape)}, {tuple(m.shape)}")
    C, P = p.shape
    if not 1 <= len(leaves) <= MAX_LEAVES:
        raise ValueError(f"grads must be 1 to {MAX_LEAVES} leaves, got "
                         f"{len(leaves)}")
    for k, g in enumerate(leaves):
        if g.dim() < 1 or g.shape[0] != C:
            raise ValueError(f"grads[{k}] must have {C} lanes on its first "
                             f"axis, got {tuple(g.shape)}")
    sizes = [math.prod(g.shape[1:]) for g in leaves]
    if sum(sizes) != P:
        raise ValueError(f"the leaves' sizes {sizes} sum to {sum(sizes)}, "
                         f"not P = {P}")
    if ok.shape != (C,):
        raise ValueError(f"ok must be ({C},), got {tuple(ok.shape)}")
    if lr.numel() != 1:
        raise ValueError(f"lr must hold one value, got {tuple(lr.shape)}")
    for name, t in (("p", p), ("m", m), ("ok", ok), ("lr", lr)) + tuple(
            (f"grads[{k}]", g) for k, g in enumerate(leaves)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class FusedSGDLanes:
    """``fused_sgd_lanes(p, grads, m, ok, lr, reset=, momentum=,
    nesterov=)`` updates the (C, P) buffers ``p`` and ``m`` in place with
    one masked momentum step (see ``ref.sgd_lanes_reference``), all of
    ``p``, ``m``, the gradient and ``lr`` float32 or all bfloat16 (the
    bfloat16 case rounds after every operation, as the reference's kernel
    does at ``p.dtype``). ``grads`` is the (C, P) gradient or a sequence of
    at most 16 contiguous leaves, leaf k a (C, *shape_k) tensor holding the
    next prod(shape_k) elements of every lane's row (the sorted-leaf layout
    of ``utils.tree``); the kernel reads each leaf in place. ``launches``
    counts kernel launches, ``bf16_launches`` those of the bfloat16 case
    among them — the CPU path never adds to either."""

    def __init__(self):
        self.launches = 0
        self.bf16_launches = 0

    def __call__(self, p: torch.Tensor, grads: Grads, m: torch.Tensor,
                 ok: torch.Tensor, lr: torch.Tensor, *, reset: bool,
                 momentum: float, nesterov: bool = False) -> None:
        leaves = _leaves(grads)
        _check(p, leaves, m, ok, lr)
        if p.device.type == "cpu":
            p_new, m_new = sgd_lanes_reference(
                p, leaves, m, ok, lr, reset=reset, momentum=momentum,
                nesterov=nesterov)
            p.copy_(p_new)
            m.copy_(m_new)
            return
        if p.device.type != "cuda":
            raise ValueError(f"fused_sgd runs on cuda or cpu, not {p.device}")
        if p.numel() == 0:
            return
        from repro_torch.kernels.fused_sgd.kernel import launch
        launch(p, leaves, m, ok, lr, reset=reset, momentum=momentum,
               nesterov=nesterov)
        self.launches += 1
        if p.dtype == torch.bfloat16:
            self.bf16_launches += 1


fused_sgd_lanes = FusedSGDLanes()
