"""Public wrapper of the lane-stacked fused SGD update.

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/fused_sgd.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.py``). There is no fallback from the one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_sgd.ref import sgd_lanes_reference


def _check(p, g, m, ok, lr) -> None:
    for name, t in (("g", g), ("m", m), ("ok", ok), ("lr", lr)):
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
    for name, t in (("p", p), ("g", g), ("m", m), ("lr", lr)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if ok.dtype != torch.bool:
        raise TypeError(f"ok must be bool, got {ok.dtype}")
    if p.dim() != 2 or g.shape != p.shape or m.shape != p.shape:
        raise ValueError(
            f"p, g, m must share one (C, P) shape: {tuple(p.shape)}, "
            f"{tuple(g.shape)}, {tuple(m.shape)}")
    if ok.shape != p.shape[:1]:
        raise ValueError(f"ok must be ({p.shape[0]},), got {tuple(ok.shape)}")
    if lr.numel() != 1:
        raise ValueError(f"lr must hold one value, got {tuple(lr.shape)}")
    if p.shape[0] > 65535:
        raise ValueError(f"at most 65535 lanes per launch, got {p.shape[0]}")
    for name, t in (("p", p), ("g", g), ("m", m), ("ok", ok), ("lr", lr)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class FusedSGDLanes:
    """``fused_sgd_lanes(p, g, m, ok, lr, reset=, momentum=, nesterov=)``
    updates the (C, P) float32 buffers ``p`` and ``m`` in place with one
    masked momentum step (see ``ref.sgd_lanes_reference``). ``launches``
    counts kernel launches — the CPU path never adds to it."""

    def __init__(self):
        self.launches = 0

    def __call__(self, p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 ok: torch.Tensor, lr: torch.Tensor, *, reset: bool,
                 momentum: float, nesterov: bool = False) -> None:
        _check(p, g, m, ok, lr)
        if p.device.type == "cpu":
            p_new, m_new = sgd_lanes_reference(
                p, g, m, ok, lr, reset=reset, momentum=momentum,
                nesterov=nesterov)
            p.copy_(p_new)
            m.copy_(m_new)
            return
        if p.device.type != "cuda":
            raise ValueError(f"fused_sgd runs on cuda or cpu, not {p.device}")
        if p.numel() == 0:
            return
        from repro_torch.kernels.fused_sgd.kernel import launch
        launch(p, g, m, ok, lr, reset=reset, momentum=momentum,
               nesterov=nesterov)
        self.launches += 1


fused_sgd_lanes = FusedSGDLanes()
