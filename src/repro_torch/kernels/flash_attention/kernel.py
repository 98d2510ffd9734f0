"""ctypes binding of ``csrc/flash_attention.cu`` (built by ``kernels.build``)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


@functools.cache
def _fn():
    """The C entry point, built and loaded on first use."""
    fn = load("flash_attention").flash_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, *, causal: bool, window: int) -> None:
    """Enqueue one attention forward on the current stream, writing
    ``out``. The caller has checked devices, dtypes, shapes and contiguity
    (``ops.py``)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                DTYPE_CODE[q.dtype], B, S, T, H, KV, hd, int(causal),
                int(window), torch.cuda.current_stream(q.device).cuda_stream)
    if err == -2:
        raise RuntimeError("flash_attention: CUDA could not encode the TMA "
                           "tensor maps of the bfloat16 kernel")
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: error {err}")
