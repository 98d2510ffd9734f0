"""ctypes binding of ``csrc/fused_sgd.cu`` (built by ``kernels.build``)."""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.kernels.build import load
from repro_torch.kernels.fused_sgd.ref import bf16_value

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


@functools.cache
def _fn():
    """The float32 C entry point, built and loaded on first use."""
    fn = load("fused_sgd").fused_sgd_lanes
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fn_bf16():
    """The bfloat16 C entry point (same arguments, bfloat16 buffers)."""
    fn = load("fused_sgd").fused_sgd_lanes_bf16
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(p: torch.Tensor, leaves: Sequence[torch.Tensor], m: torch.Tensor,
           ok: torch.Tensor, lr: torch.Tensor, *, reset: bool,
           momentum: float, nesterov: bool, span: int = 0) -> None:
    """Enqueue one in-place update on the current stream. ``leaves`` are
    the gradient's (C, *shape_k) leaves in row order; ``span`` forces the
    elements a block updates (0: the kernel's default). A bfloat16 set
    (p, m, leaves and lr) goes to the bfloat16 entry, with ``momentum``
    rounded to bfloat16 here, as the reference's weakly typed multiply
    rounds it. The caller has checked devices, dtypes, shapes and
    contiguity (``ops.py``)."""
    C, n = p.shape
    bf16 = p.dtype == torch.bfloat16
    fn = _fn_bf16() if bf16 else _fn()
    if bf16:
        momentum = bf16_value(momentum)
    leaves = [g for g in leaves if g.numel() > 0]
    ptrs = (ctypes.c_void_p * len(leaves))(*(g.data_ptr() for g in leaves))
    sizes = (ctypes.c_longlong * len(leaves))(
        *(g.numel() // C for g in leaves))
    err = fn(p.data_ptr(), m.data_ptr(), ptrs, sizes, len(leaves),
             ok.data_ptr(), lr.data_ptr(), C, n, float(momentum),
             int(nesterov), int(reset), int(span),
             torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_sgd kernel launch failed: cudaError {err}")
