"""ctypes bindings of ``csrc/flash_attention.cu`` (the forward) and
``csrc/flash_attention_bwd.cu`` (the backward), built by
``kernels.build``."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.build import load

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


@functools.cache
def _fwd():
    """The forward's C entry point, built and loaded on first use."""
    fn = load("flash_attention").flash_attention_fwd
    fn.argtypes = _FWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd():
    """The backward's C entry point, built and loaded on first use."""
    fn = load("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, *, causal: bool, window: int,
           lse: Optional[torch.Tensor] = None) -> None:
    """Enqueue one attention forward on the current stream, writing
    ``out`` and, when given, the (B, H, S) float32 ``lse``. The caller has
    checked devices, dtypes, shapes and contiguity (``ops.py``)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    err = _fwd()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 DTYPE_CODE[q.dtype], B, S, T, H, KV, hd, int(causal),
                 int(window), torch.cuda.current_stream(q.device).cuda_stream)
    if err == -2:
        raise RuntimeError("flash_attention: CUDA could not encode the TMA "
                           "tensor maps of the bfloat16 kernel")
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: error {err}")


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
               dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor, *,
               causal: bool, window: int) -> None:
    """Enqueue the attention backward's two kernels on the current stream,
    writing ``dq``, ``dk``, ``dv`` and the (B, H, S) float32 scratch
    ``delta``. The caller has checked the arguments (``ops.py``)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    err = _bwd()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 DTYPE_CODE[q.dtype], B, S, T, H, KV, hd, int(causal),
                 int(window), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bwd kernel launch failed: error {err}")
