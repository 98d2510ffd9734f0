"""ctypes binding of ``csrc/fused_sgd.cu`` (built by ``kernels.build``)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


@functools.cache
def _fn():
    """The C entry point, built and loaded on first use."""
    fn = load("fused_sgd").fused_sgd_lanes
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
           ok: torch.Tensor, lr: torch.Tensor, *, reset: bool,
           momentum: float, nesterov: bool) -> None:
    """Enqueue one in-place update on the current stream. The caller has
    checked devices, dtypes, shapes and contiguity (``ops.py``)."""
    C, n = p.shape
    err = _fn()(p.data_ptr(), g.data_ptr(), m.data_ptr(), ok.data_ptr(),
                lr.data_ptr(), C, n, float(momentum), int(nesterov),
                int(reset), torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_sgd kernel launch failed: cudaError {err}")
