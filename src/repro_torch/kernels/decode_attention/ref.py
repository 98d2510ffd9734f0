"""Plain PyTorch version of single-query decode attention over a KV cache
— the twin of the JAX package's
``kernels/decode_attention/ref.py::decode_attention_reference`` and the
function ``csrc/decode_attention.cu`` computes. The CPU runs it in place
of the kernel; on the card it is what the kernel is held against."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, lengths: torch.Tensor, *,
                               window: int = 0) -> torch.Tensor:
    """q (B, KV, G, hd), k/v (B, KV, T, hd), lengths (B,) int valid tokens
    per sequence -> (B, KV, G, hd) in q's dtype. Keys at ``t < length``
    (and ``t >= length - window`` when ``window > 0``) are attended; the
    arithmetic runs in float32."""
    hd = q.shape[-1]
    t = k.shape[2]
    s = torch.einsum("bkgd,bktd->bkgt", q.float(), k.float()) / (hd ** 0.5)
    cols = torch.arange(t, device=q.device)[None, :]
    lens = lengths.to(q.device).long()[:, None]
    valid = cols < lens
    if window > 0:
        valid &= cols >= torch.clamp(lens - window, min=0)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,bktd->bkgd", p, v.float()).to(q.dtype)
