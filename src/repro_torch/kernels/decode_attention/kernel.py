"""ctypes binding of ``csrc/decode_attention.cu`` (built by ``kernels.build``)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


@functools.cache
def _fn():
    """The C entry point, built and loaded on first use."""
    fn = load("decode_attention").decode_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           lengths: torch.Tensor, out: torch.Tensor,
           partials: torch.Tensor | None, *, window: int,
           splits: int) -> None:
    """Enqueue one decode-attention step on the current stream, writing
    ``out``: the split kernel over ``splits`` blocks per (sequence, kv
    head) and, when ``splits > 1``, the combine kernel, which merges the
    float32 ``partials`` (B, KV, splits, G, hd + 2). The caller has
    checked devices, dtypes, shapes and contiguity and allocated the
    scratch (``ops.py``)."""
    B, _, H, hd = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    err = _fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                lengths.data_ptr(), out.data_ptr(),
                None if partials is None else partials.data_ptr(),
                DTYPE_CODE[q.dtype], DTYPE_CODE[k_cache.dtype], B, T, KV,
                H // KV, hd, int(window), int(splits),
                torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"decode_attention kernel launch failed: error {err}")
