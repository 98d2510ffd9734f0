"""Public wrapper of the Mamba2 SSD chunked scan in the model layout:
x (B, L, H, P), dt (B, L, H), a (H,), B/C (B, L, G, N) (the reference's
``ops.py::ssd_scan``).

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/ssd_scan.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.py``). There is no fallback from the one to the other. The
kernel reads strided views in place and masks a ragged last chunk itself,
so the wrapper copies, pads and transposes nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.ref import ssd_reference

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_MAX_CHUNK = 128
KERNEL_MAX_STATE = 128      # N
KERNEL_MAX_HEADDIM = 64     # P


def _check(x, dt, a, b_mat, c_mat, chunk) -> None:
    for name, t in (("dt", dt), ("a", a), ("b_mat", b_mat), ("c_mat", c_mat)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("b_mat", b_mat), ("c_mat", c_mat)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    for name, t in (("dt", dt), ("a", a)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if x.dim() != 4 or b_mat.dim() != 4 or c_mat.shape != b_mat.shape:
        raise ValueError(
            f"x must be (B, L, H, P) and b_mat, c_mat one (B, L, G, N) "
            f"shape: {tuple(x.shape)}, {tuple(b_mat.shape)}, "
            f"{tuple(c_mat.shape)}")
    B, L, H, P = x.shape
    G = b_mat.shape[2]
    if tuple(dt.shape) != (B, L, H) or tuple(a.shape) != (H,):
        raise ValueError(f"dt must be ({B}, {L}, {H}) and a ({H},), got "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}")
    if b_mat.shape[:2] != x.shape[:2] or G == 0 or H % G != 0:
        raise ValueError(f"b_mat {tuple(b_mat.shape)} does not match x "
                         f"{tuple(x.shape)} (same B and L, H a multiple "
                         "of G)")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b_mat: torch.Tensor, c_mat: torch.Tensor, *,
                   chunk: int = 128) -> torch.Tensor:
    """The plain version: what the CPU runs, and what the kernel is held
    against on the card (float32 inside the chunk, the kernel's
    contract)."""
    return ssd_reference(x, dt, a, b_mat, c_mat, chunk)


class SSDScan:
    """``ssd_scan(x, dt, a, b_mat, c_mat, chunk=128)``: x (B, L, H, P),
    dt (B, L, H) float32, a (H,) float32, b_mat/c_mat (B, L, G, N) in x's
    dtype -> y (B, L, H, P) in x's dtype (see ``ref.ssd_reference``).
    ``launches`` counts kernel launches — the CPU path never adds to it."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b_mat: torch.Tensor, c_mat: torch.Tensor, *,
                 chunk: int = 128) -> torch.Tensor:
        _check(x, dt, a, b_mat, c_mat, chunk)
        if x.device.type == "cpu":
            return ssd_scan_plain(x, dt, a, b_mat, c_mat, chunk=chunk)
        if x.device.type != "cuda":
            raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
        B, L, H, P = x.shape
        N = b_mat.shape[3]
        if chunk > KERNEL_MAX_CHUNK or N > KERNEL_MAX_STATE \
                or P > KERNEL_MAX_HEADDIM:
            raise ValueError(
                f"the kernel takes chunk <= {KERNEL_MAX_CHUNK}, N <= "
                f"{KERNEL_MAX_STATE} and P <= {KERNEL_MAX_HEADDIM}, got "
                f"{chunk}, {N}, {P}")
        if L == 0 or P == 0 or N == 0:
            raise ValueError(f"empty scan: x {tuple(x.shape)}, N={N}")
        if B > 65535:
            raise ValueError(f"at most 65535 sequences per launch, got {B}")
        for name, t in (("x", x), ("b_mat", b_mat), ("c_mat", c_mat)):
            if t.stride(-1) != 1:
                raise ValueError(f"{name}'s last dim must be contiguous")
        if not a.is_contiguous():
            raise ValueError("a must be contiguous")
        y = torch.empty((B, L, H, P), dtype=x.dtype, device=x.device)
        from repro_torch.kernels.ssd_scan.kernel import launch
        launch(x, dt, a, b_mat, c_mat, y, chunk=chunk)
        self.launches += 1
        return y


ssd_scan = SSDScan()
