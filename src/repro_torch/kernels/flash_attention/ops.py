"""Public wrappers of blockwise causal GQA attention, in the model's
(B, S, H, hd) layout (the reference's ``ops.py::flash_attention``), and of
its backward, which training needs.

On a CUDA tensor each launches its hand-written Hopper kernel
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``) or raises;
on a CPU tensor it runs the plain version (``ref.py``). There is no
fallback from the one to the other. On the card, a call whose inputs
need a gradient goes through ``FlashAttentionFn``: its forward launches the
forward kernel with the per-row ``lse`` output and saves (q, k, v, lse);
its backward launches the backward kernel. On the CPU, autograd runs
through the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.flash_attention.ref import (
    attention_lse_plain, attention_reference, flash_attention_bwd_plain,
)

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


def _check_cuda(what: str, **operands: torch.Tensor) -> None:
    """What the kernels take beyond ``_check``: a CUDA device, hd in
    ``KERNEL_HEAD_DIMS``, contiguous operands, at most 65535 sequences."""
    q = operands["q"]
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {q.device}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernel takes hd in {KERNEL_HEAD_DIMS}, got "
                         f"{q.shape[-1]}")
    for name, t in operands.items():
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if q.shape[0] > 65535:
        raise ValueError(f"at most 65535 sequences per launch, got "
                         f"{q.shape[0]}")


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
    ``ref.attention_reference``). ``launches`` counts forward kernel
    launches, those of ``FlashAttentionFn`` included — the CPU path never
    adds to it."""

    def __init__(self):
        self.launches = 0

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0) -> torch.Tensor:
        _check(q, k, v, causal, window)
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal=causal,
                                         window=window).contiguous()
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return FlashAttentionFn.apply(q, k, v, causal, window)
        return self._launch(q, k, v, causal, window, lse=False)[0]

    def _launch(self, q, k, v, causal, window, *, lse: bool):
        _check_cuda("flash_attention", q=q, k=k, v=v)
        if q.dtype == torch.bfloat16:
            for name, t in (("q", q), ("k", k), ("v", v)):
                if t.data_ptr() % 16:
                    raise ValueError(f"{name} must be 16-byte aligned: the "
                                     "bfloat16 kernel loads it with TMA")
        out = torch.empty_like(q)
        b, s, h, _ = q.shape
        lse_t = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
                 if lse else None)
        if q.numel() == 0:
            return out, lse_t
        from repro_torch.kernels.flash_attention.kernel import launch
        launch(q, k, v, out, causal=causal, window=window, lse=lse_t)
        self.launches += 1
        return out, lse_t


flash_attention = FlashAttention()


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward with its per-row log-sum-exp: (out (B, S, H, hd), lse
    (B, H, S) float32). On CUDA tensors one forward kernel launch, the
    forward of ``FlashAttentionFn`` (counted on ``flash_attention.launches``);
    on CPU tensors the plain versions."""
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        return (flash_attention_plain(q, k, v, causal=causal,
                                      window=window).contiguous(),
                attention_lse_plain(q, k, causal=causal, window=window))
    return flash_attention._launch(q, k, v, causal, window, lse=True)


class FlashAttentionBwd:
    """``flash_attention_bwd(q, k, v, dout, lse, causal=True, window=0)``
    -> (dq, dk, dv) in q's dtype, for T == S: the gradient of
    ``flash_attention`` at (q, k, v) against ``dout``, given the forward's
    ``lse`` (B, H, S) float32 from ``flash_attention_lse``. On the CPU it
    runs ``ref.flash_attention_bwd_plain``, which recomputes it.
    ``launches`` counts kernel launches (one a call, which runs the dq and
    dkdv kernels) — the CPU path never adds to it."""

    def __init__(self):
        self.launches = 0

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 dout: torch.Tensor, lse: torch.Tensor, *,
                 causal: bool = True, window: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        _check(q, k, v, causal, window)
        B, S, H, _ = q.shape
        if k.shape[1] != S:
            raise ValueError(f"the backward takes T == S, got S={S}, "
                             f"T={k.shape[1]}")
        if (dout.shape != q.shape or dout.dtype != q.dtype
                or dout.device != q.device):
            raise ValueError(f"dout must be q's shape, dtype and device, got "
                             f"{tuple(dout.shape)} {dout.dtype} {dout.device}")
        if (lse.shape != (B, H, S) or lse.dtype != torch.float32
                or lse.device != q.device):
            raise ValueError(f"lse must be ({B}, {H}, {S}) float32 on "
                             f"{q.device}, got {tuple(lse.shape)} {lse.dtype}")
        if q.device.type == "cpu":
            return flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                             window=window)
        _check_cuda("flash_attention_bwd", q=q, k=k, v=v, dout=dout, lse=lse)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        if q.numel() == 0:
            return dq, dk, dv
        delta = torch.empty_like(lse)
        from repro_torch.kernels.flash_attention.kernel import launch_bwd
        launch_bwd(q, k, v, dout, lse, delta, dq, dk, dv, causal=causal,
                   window=window)
        self.launches += 1
        return dq, dk, dv


flash_attention_bwd = FlashAttentionBwd()


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a gradient on the card: the forward kernel with
    ``lse`` (``flash_attention_lse``), the backward kernel
    (``flash_attention_bwd``); both are looked up in this module when
    called, so a checking harness can wrap them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, dout.contiguous(), lse,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None
