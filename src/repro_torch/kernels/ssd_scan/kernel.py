"""ctypes binding of ``csrc/ssd_scan.cu`` (built by ``kernels.build``)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
             + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])


@functools.cache
def _fn():
    """The C entry point, built and loaded on first use."""
    fn = load("ssd_scan").ssd_scan_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
           b_mat: torch.Tensor, c_mat: torch.Tensor, y: torch.Tensor, *,
           chunk: int) -> None:
    """Enqueue one scan on the current stream, writing ``y``. The caller
    has checked devices, dtypes, shapes and strides (``ops.py``)."""
    B, L, H, P = x.shape
    G, N = b_mat.shape[2], b_mat.shape[3]
    strides = (ctypes.c_int64 * 12)(*x.stride()[:3], *dt.stride(),
                                    *b_mat.stride()[:3], *c_mat.stride()[:3])
    err = _fn()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
                c_mat.data_ptr(), y.data_ptr(), DTYPE_CODE[x.dtype], B, L, H,
                G, P, N, chunk, strides,
                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: error {err}")
