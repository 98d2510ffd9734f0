"""Public wrapper of blockwise causal GQA attention, in the model's
(B, S, H, hd) layout (the reference's ``ops.py::flash_attention``).

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/flash_attention.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.py``). There is no fallback from the one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import attention_reference

KERNEL_HEAD_DIMS = (32, 64, 128, 160)
_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, causal, window) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"attention takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"q must be (B, S, H, hd) and k, v one (B, T, KV, hd) shape: "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    (B, S, H, hd), (Bk, T, KV, hdk) = q.shape, k.shape
    if B != Bk or hd != hdk or KV == 0 or H % KV != 0:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}"
                         " (same B and hd, H a multiple of KV)")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if (causal or window > 0) and T < S:
        raise ValueError(f"a masked attention needs T >= S (every query row "
                         f"sees a key), got S={S}, T={T}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The plain version in the model's layout: what the CPU runs, and
    what the kernel is held against on the card."""
    t = (0, 2, 1, 3)
    return attention_reference(q.permute(t), k.permute(t), v.permute(t),
                               causal=causal, window=window).permute(t)


class FlashAttention:
    """``flash_attention(q, k, v, causal=True, window=0)``: q (B, S, H, hd),
    k/v (B, T, KV, hd) -> (B, S, H, hd) in q's dtype (see
    ``ref.attention_reference``). ``launches`` counts kernel launches — the
    CPU path never adds to it."""

    def __init__(self):
        self.launches = 0

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0) -> torch.Tensor:
        _check(q, k, v, causal, window)
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal=causal,
                                         window=window).contiguous()
        if q.device.type != "cuda":
            raise ValueError(f"flash_attention runs on cuda or cpu, not "
                             f"{q.device}")
        if q.shape[-1] not in KERNEL_HEAD_DIMS:
            raise ValueError(f"the kernel takes hd in {KERNEL_HEAD_DIMS}, got "
                             f"{q.shape[-1]}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned: the "
                                 "bfloat16 kernel loads it with TMA")
        if q.shape[0] > 65535:
            raise ValueError(f"at most 65535 sequences per launch, got "
                             f"{q.shape[0]}")
        out = torch.empty_like(q)
        if q.numel() == 0:
            return out
        from repro_torch.kernels.flash_attention.kernel import launch
        launch(q, k, v, out, causal=causal, window=window)
        self.launches += 1
        return out


flash_attention = FlashAttention()
