"""Plain PyTorch versions of blockwise causal GQA attention — the twin of
the JAX package's ``kernels/flash_attention/ref.py::attention_reference``
and the function ``csrc/flash_attention.cu`` computes — and of what the
kernels add for training: the forward's per-row log-sum-exp and the
backward (``csrc/flash_attention_bwd.cu``), computed by autograd of
``attention_reference``. The CPU runs them in place of the kernels; on the
card they are what the kernels are held against."""
from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


def _mask(sq: int, t: int, causal: bool, window: int,
          device: torch.device) -> torch.Tensor:
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(t, device=device)[None, :]
    mask = torch.ones((sq, t), dtype=torch.bool, device=device)
    if causal:
        mask &= rows >= cols
    if window > 0:
        mask &= (rows - cols) < window
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int,
            dtype: torch.dtype) -> torch.Tensor:
    """Masked scaled scores (B, KV, G, Sq, T) in ``dtype``."""
    b, h, sq, hd = q.shape
    kv, t = k.shape[1], k.shape[2]
    qf = q.reshape(b, kv, h // kv, sq, hd).to(dtype)
    s = torch.einsum("bkgsd,bktd->bkgst", qf, k.to(dtype)) / (hd ** 0.5)
    return torch.where(_mask(sq, t, causal, window, q.device), s, NEG_INF)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q (B, H, Sq, hd), k/v (B, KV, T, hd) -> (B, H, Sq, hd) in q's dtype.
    Query head h reads kv head ``h // (H // KV)``; scores, softmax and the
    PV product run in ``dtype``: float32, or float64 for an exact
    yardstick."""
    b, h, sq, hd = q.shape
    p = torch.softmax(_scores(q, k, causal, window, dtype), dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.to(dtype))
    return out.reshape(b, h, sq, hd).to(q.dtype)


_MODEL = (0, 2, 1, 3)       # (B, S, H, hd) <-> (B, H, S, hd)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """The forward's ``lse`` in the model's layout: q (B, S, H, hd), k
    (B, T, KV, hd) -> (B, H, S) float32, each row's log-sum-exp of its
    visible scaled scores."""
    b, s, h, _ = q.shape
    lse = torch.logsumexp(_scores(q.permute(_MODEL), k.permute(_MODEL),
                                  causal, window, torch.float32), dim=-1)
    return lse.reshape(b, h, s)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              dtype: torch.dtype = torch.float32
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward in the model's layout, by autograd of
    ``attention_reference`` computed in ``dtype``: q, dout (B, S, H, hd),
    k, v (B, T, KV, hd) -> (dq, dk, dv) in q's dtype (rounded once from
    ``dtype``), dk and dv summed over each kv head's group of query
    heads."""
    with torch.enable_grad():
        leaves = [x.detach().to(dtype).requires_grad_() for x in (q, k, v)]
        out = attention_reference(*(x.permute(_MODEL) for x in leaves),
                                  causal=causal, window=window, dtype=dtype)
        grads = torch.autograd.grad(out, leaves,
                                    dout.to(dtype).permute(_MODEL))
    return tuple(g.to(q.dtype) for g in grads)
