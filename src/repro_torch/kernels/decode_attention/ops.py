"""Public wrapper of single-query decode attention, in the model's decode
layout: q (B, 1, H, hd), caches (B, T, KV, hd), lengths (B,) (the
reference's ``ops.py::decode_attention``).

On a CUDA tensor it launches the hand-written Hopper kernels
(``csrc/decode_attention.cu``: a split kernel over ``num_splits`` blocks
per (sequence, kv head) and, with more than one split, a combine kernel)
or raises; on a CPU tensor it runs the plain version (``ref.py``). There
is no fallback from the one to the other.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.decode_attention.ref import (
    decode_attention_reference,
)

KERNEL_HEAD_DIMS = (32, 64, 128, 160)
KERNEL_MAX_GROUP = 16
# (q dtype, cache dtype) pairs the kernel takes; the serving path keeps
# bfloat16 activations over a float32 cache
KERNEL_DTYPES = ((torch.float32, torch.float32),
                 (torch.bfloat16, torch.bfloat16),
                 (torch.bfloat16, torch.float32))
# The split rule. The split kernel takes shared memory for exactly
# BLOCKS_PER_SM blocks an SM (kBlockSmem), so its grid runs in waves of
# BLOCKS_PER_SM * SMs blocks, and a wave's unfilled tail idles the card.
# No split holds fewer than MIN_SPLIT_KEYS cache positions: more than one
# split costs a combine launch and a round trip of the partials.
BLOCKS_PER_SM = 2
MIN_SPLIT_KEYS = 128


@functools.cache
def num_splits(batch: int, kv_heads: int, cache_len: int, sms: int) -> int:
    """How many blocks share the keys of one (sequence, kv head): the S
    whose grid of ``batch * kv_heads * S`` blocks fills its waves best
    (the least such S, to a hundredth), for S up to two waves' worth and
    at most one split per ``MIN_SPLIT_KEYS`` positions. A function of the
    shapes only: the lengths stay on the card."""
    slots, pairs = BLOCKS_PER_SM * sms, batch * kv_heads
    most = max(1, min(cache_len // MIN_SPLIT_KEYS, -(-2 * slots // pairs)))

    def fill(s):
        blocks = pairs * s
        return round(blocks / (-(-blocks // slots) * slots), 2)

    return max(range(1, most + 1), key=lambda s: (fill(s), -s))


def split_scratch(q: torch.Tensor, k_cache: torch.Tensor,
                  splits: int) -> torch.Tensor | None:
    """The float32 partials (B, KV, S, G, hd + 2) the split kernel writes
    and the combine kernel reads, or None for one split (no combine)."""
    if splits == 1:
        return None
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    return torch.empty((B, KV, splits, H // KV, hd + 2), dtype=torch.float32,
                       device=q.device)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k_cache, v_cache, lengths, window) -> None:
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if v_cache.dtype != k_cache.dtype:
        raise TypeError(f"v_cache is {v_cache.dtype}, k_cache is "
                        f"{k_cache.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
    if lengths.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    if (q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4
            or v_cache.shape != k_cache.shape):
        raise ValueError(
            f"q must be (B, 1, H, hd) and the caches one (B, T, KV, hd) "
            f"shape: {tuple(q.shape)}, {tuple(k_cache.shape)}, "
            f"{tuple(v_cache.shape)}")
    (B, _, H, hd), (Bk, _, KV, hdk) = q.shape, k_cache.shape
    if B != Bk or hd != hdk or KV == 0 or H % KV != 0:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache "
                         f"{tuple(k_cache.shape)} (same B and hd, H a "
                         "multiple of KV)")
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, lengths: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """The plain version in the model's layout: what the CPU runs, and
    what the kernel is held against on the card."""
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    out = decode_attention_reference(
        q[:, 0].reshape(b, kv, h // kv, hd), k_cache.transpose(1, 2),
        v_cache.transpose(1, 2), lengths, window=window)
    return out.reshape(b, 1, h, hd)


class DecodeAttention:
    """``decode_attention(q, k_cache, v_cache, lengths, window=0)``:
    q (B, 1, H, hd), caches (B, T, KV, hd), lengths (B,) in [1, T] ->
    (B, 1, H, hd) in q's dtype (see ``ref.decode_attention_reference``).
    On the card ``lengths`` is int32 and is never read by the host.
    ``launches`` counts calls that launched the kernels (the split kernel
    and, with more than one split, the combine) — the CPU path never adds
    to it."""

    def __init__(self):
        self.launches = 0

    def __call__(self, q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, *,
                 window: int = 0) -> torch.Tensor:
        _check(q, k_cache, v_cache, lengths, window)
        B, _, H, hd = q.shape
        KV = k_cache.shape[2]
        if q.device.type == "cpu":
            return decode_attention_plain(q, k_cache, v_cache, lengths,
                                          window=window)
        if q.device.type != "cuda":
            raise ValueError(f"decode_attention runs on cuda or cpu, not "
                             f"{q.device}")
        if (q.dtype, k_cache.dtype) not in KERNEL_DTYPES:
            raise TypeError(f"the kernel takes (q, cache) dtypes in "
                            f"{KERNEL_DTYPES}, got ({q.dtype}, "
                            f"{k_cache.dtype})")
        if lengths.dtype != torch.int32:
            raise TypeError(f"lengths must be int32 on the card, got "
                            f"{lengths.dtype}")
        if hd not in KERNEL_HEAD_DIMS:
            raise ValueError(f"the kernel takes hd in {KERNEL_HEAD_DIMS}, "
                             f"got {hd}")
        if H // KV > KERNEL_MAX_GROUP:
            raise ValueError(f"the kernel takes at most {KERNEL_MAX_GROUP} "
                             f"query heads per kv head, got {H // KV}")
        if B > 65535:      # B is the grid's z
            raise ValueError(f"at most 65535 sequences per launch, got {B}")
        for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                        ("lengths", lengths)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
        if k_cache.shape[1] == 0:
            raise ValueError("the cache holds no position")
        splits = num_splits(B, KV, k_cache.shape[1],
                            _sm_count(q.device.index))
        out = torch.empty_like(q)
        from repro_torch.kernels.decode_attention.kernel import launch
        launch(q, k_cache, v_cache, lengths, out,
               split_scratch(q, k_cache, splits), window=window,
               splits=splits)
        self.launches += 1
        return out


decode_attention = DecodeAttention()
