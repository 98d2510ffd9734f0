"""Plain PyTorch version of blockwise causal GQA attention — the twin of
the JAX package's ``kernels/flash_attention/ref.py::attention_reference``
and the function ``csrc/flash_attention.cu`` computes. The CPU runs it in
place of the kernel; on the card it is what the kernel is held against."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """q (B, H, Sq, hd), k/v (B, KV, T, hd) -> (B, H, Sq, hd) in q's dtype.
    Query head h reads kv head ``h // (H // KV)``; scores, softmax and the
    PV product run in float32."""
    b, h, sq, hd = q.shape
    kv, t = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.reshape(b, kv, g, sq, hd).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qf, k.float()) / (hd ** 0.5)
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((sq, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= rows >= cols
    if window > 0:
        mask &= (rows - cols) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return out.reshape(b, h, sq, hd).to(q.dtype)
