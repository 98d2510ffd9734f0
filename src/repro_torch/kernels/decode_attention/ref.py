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


# The card's decomposition (``csrc/decode_attention.cu``), op for op: S
# blocks per (sequence, kv head) each reduce their share of the keys to a
# float32 partial (acc, m, l), and a combine merges the S partials.

SPLIT_TILE = 16     # keys a stage of the kernel's ring holds (kTileKeys)


def split_spans(lengths: torch.Tensor, t: int, splits: int, *,
                window: int = 0, tile: int = SPLIT_TILE):
    """(start, end), each (B, S) int64: split s of sequence b takes keys
    ``start <= key < end`` — its share of the live range [lo, len), cut
    evenly and rounded up to whole tiles. A split with ``start >= end``
    has no keys."""
    lens = lengths.long().clamp(0, t)
    lo = (lens - window).clamp(min=0) if window > 0 else torch.zeros_like(lens)
    share = ((lens - lo + splits - 1) // splits + tile - 1) // tile * tile
    start = lo[:, None] + torch.arange(splits, device=lens.device) * share[:, None]
    end = torch.minimum(start + share[:, None], lens[:, None])
    return start, end


def decode_attention_split_partials(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, lengths: torch.Tensor, *,
                                    splits: int, window: int = 0,
                                    tile: int = SPLIT_TILE) -> torch.Tensor:
    """The split kernel's output: q (B, KV, G, hd), k/v (B, KV, T, hd) ->
    float32 (B, KV, S, G, hd + 2), per split and row the unnormalised
    ``acc = sum_t exp(s_t - m) v_t`` then ``m`` (the split's max score,
    -inf without keys) and ``l = sum_t exp(s_t - m)``."""
    hd, t = q.shape[-1], k.shape[2]
    s = torch.einsum("bkgd,bktd->bkgt", q.float(), k.float()) / (hd ** 0.5)
    start, end = split_spans(lengths.to(q.device), t, splits, window=window,
                             tile=tile)
    cols = torch.arange(t, device=q.device)
    live = ((cols >= start[..., None]) & (cols < end[..., None]))
    live = live[:, None, :, None, :]                     # (B, 1, S, 1, T)
    s = torch.where(live, s[:, :, None], -torch.inf)     # (B, KV, S, G, T)
    m = s.amax(-1)
    p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bksgt,bktd->bksgd", p, v.float())
    return torch.cat([acc, m[..., None], p.sum(-1)[..., None]], -1)


def decode_attention_combine(partials: torch.Tensor,
                             dtype: torch.dtype) -> torch.Tensor:
    """The combine kernel: (B, KV, S, G, hd + 2) partials -> (B, KV, G, hd)
    in ``dtype``, by the log-sum-exp rule; an empty split weighs
    exp(-inf) = 0, and a row without any key is 0."""
    hd = partials.shape[-1] - 2
    acc, m, l = partials[..., :hd], partials[..., hd], partials[..., hd + 1]
    mx = m.amax(2, keepdim=True)
    c = torch.where(torch.isneginf(mx), 0.0, torch.exp(m - mx))
    num = (c[..., None] * acc).sum(2)
    den = (c * l).sum(2)
    return (num / den.clamp(min=1e-30)[..., None]).to(dtype)
