"""ctypes binding of ``csrc/ssd_scan.cu`` (built by ``kernels.build``)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTE_CODE = {"cuda_cores": 0, "tensor_cores": 1}
# the passes of one scan, bits of ``passes``
STATES, PASSING, OUTPUTS = 1, 2, 4
ALL_PASSES = STATES | PASSING | OUTPUTS
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
             + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])


@functools.cache
def _fn():
    """The C entry point, built and loaded on first use."""
    fn = load("ssd_scan").ssd_scan_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
           b_mat: torch.Tensor, c_mat: torch.Tensor, y: torch.Tensor,
           states: torch.Tensor, decay: torch.Tensor, *, chunk: int,
           route: str, passes: int = ALL_PASSES) -> None:
    """Enqueue the ``passes`` of one scan on the current stream: chunk
    states into ``states``/``decay``, state passing in place on
    ``states``, chunk outputs into ``y``. The caller has checked devices,
    dtypes, shapes and strides and allocated the scratch (``ops.py``)."""
    B, L, H, P = x.shape
    G, N = b_mat.shape[2], b_mat.shape[3]
    strides = (ctypes.c_int64 * 12)(*x.stride()[:3], *dt.stride(),
                                    *b_mat.stride()[:3], *c_mat.stride()[:3])
    err = _fn()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
                c_mat.data_ptr(), y.data_ptr(), states.data_ptr(),
                decay.data_ptr(), DTYPE_CODE[x.dtype], ROUTE_CODE[route],
                passes, B, L, H, G, P, N, chunk, strides,
                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: error {err}")


def launch_state_passing(states: torch.Tensor, decay: torch.Tensor) -> None:
    """Enqueue pass B alone, in place on ``states`` (B, NC, H, N, P) with
    ``decay`` (B, NC, H), both contiguous float32: the scan's sizes as a
    chunk of 1 over NC steps (pass B reads no input but these two)."""
    B, NC, H, N, P = states.shape
    s, d = states.data_ptr(), decay.data_ptr()
    err = _fn()(s, d, d, s, s, s, s, d, DTYPE_CODE[torch.float32],
                ROUTE_CODE["cuda_cores"], PASSING, B, NC, H, 1, P, N, 1,
                (ctypes.c_int64 * 12)(),
                torch.cuda.current_stream(states.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan state passing failed: error {err}")
