"""ctypes binding of ``csrc/fused_sgd.cu`` (built by ``kernels.build``)."""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.kernels.build import load

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


@functools.cache
def _fn():
    """The C entry point, built and loaded on first use."""
    fn = load("fused_sgd").fused_sgd_lanes
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(p: torch.Tensor, leaves: Sequence[torch.Tensor], m: torch.Tensor,
           ok: torch.Tensor, lr: torch.Tensor, *, reset: bool,
           momentum: float, nesterov: bool, span: int = 0) -> None:
    """Enqueue one in-place update on the current stream. ``leaves`` are
    the gradient's (C, *shape_k) leaves in row order; ``span`` forces the
    elements a block updates (0: the kernel's default). The caller has
    checked devices, dtypes, shapes and contiguity (``ops.py``)."""
    C, n = p.shape
    leaves = [g for g in leaves if g.numel() > 0]
    ptrs = (ctypes.c_void_p * len(leaves))(*(g.data_ptr() for g in leaves))
    sizes = (ctypes.c_longlong * len(leaves))(
        *(g.numel() // C for g in leaves))
    err = _fn()(p.data_ptr(), m.data_ptr(), ptrs, sizes, len(leaves),
                ok.data_ptr(), lr.data_ptr(), C, n, float(momentum),
                int(nesterov), int(reset), int(span),
                torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_sgd kernel launch failed: cudaError {err}")
