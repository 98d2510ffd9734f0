"""Public wrapper of the Mamba2 SSD chunked scan in the model layout:
x (B, L, H, P), dt (B, L, H), a (H,), B/C (B, L, G, N) (the reference's
``ops.py::ssd_scan``).

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/ssd_scan.cu``) or raises; on a CPU tensor it runs the plain
version (``ref.py``). There is no fallback from the one to the other. The
kernel reads strided views in place and masks a ragged last chunk itself,
so the wrapper copies, pads and transposes nothing; it allocates the
kernel's float32 scratch, the per-chunk states (B, NC, H, N, P) and decays
(B, NC, H). One call enqueues the kernel's three passes (chunk states,
state passing, chunk outputs); ``chunk_states``, ``state_passing`` and
``chunk_outputs`` run one pass each, to hold each against its plain pass.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels.ssd_scan.ref import (
    pad_to_chunks, ssd_chunk_outputs, ssd_chunk_states, ssd_reference,
    ssd_state_passing,
)

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_MAX_CHUNK = 128
KERNEL_MAX_STATE = 128      # N
KERNEL_MAX_HEADDIM = 64     # P
TENSOR_CORE_CHUNKS = (64, 128)


def kernel_route(dtype: torch.dtype, chunk: int, n: int, p: int) -> str:
    """The body that runs the kernel's chunk-states and chunk-outputs
    passes: ``"tensor_cores"`` (wgmma on bfloat16 tiles, each float32
    operand split into bfloat16 hi + lo) for bfloat16 at a chunk of 64 or
    128 with N and P multiples of 16, the shapes its 64-row tiles take;
    ``"cuda_cores"`` (float32 FMAs) for every other shape and for
    float32."""
    if (dtype == torch.bfloat16 and chunk in TENSOR_CORE_CHUNKS
            and n % 16 == 0 and p % 16 == 0):
        return "tensor_cores"
    return "cuda_cores"


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


def _device(x) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    return x.device.type


def _check_kernel(x, a, b_mat, c_mat, chunk) -> None:
    """What the kernel takes beyond ``_check``."""
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


def _scratch(x, b_mat, chunk):
    """The kernel's float32 scratch: states (B, NC, H, N, P), decays
    (B, NC, H)."""
    B, L, H, P = x.shape
    nc = -(-L // chunk)
    return (torch.empty((B, nc, H, b_mat.shape[3], P), dtype=torch.float32,
                        device=x.device),
            torch.empty((B, nc, H), dtype=torch.float32, device=x.device))


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
    ``launches`` counts kernel launches, one a call (three passes on the
    card), and ``routes`` the same launches by ``kernel_route`` — the CPU
    path never adds to them."""

    def __init__(self):
        self.launches = 0
        self.routes = Counter()

    def __call__(self, x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b_mat: torch.Tensor, c_mat: torch.Tensor, *,
                 chunk: int = 128) -> torch.Tensor:
        _check(x, dt, a, b_mat, c_mat, chunk)
        if _device(x) == "cpu":
            return ssd_scan_plain(x, dt, a, b_mat, c_mat, chunk=chunk)
        _check_kernel(x, a, b_mat, c_mat, chunk)
        route = kernel_route(x.dtype, chunk, b_mat.shape[3], x.shape[3])
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        states, decay = _scratch(x, b_mat, chunk)
        from repro_torch.kernels.ssd_scan.kernel import launch
        launch(x, dt, a, b_mat, c_mat, y, states, decay, chunk=chunk,
               route=route)
        self.launches += 1
        self.routes[route] += 1
        return y


ssd_scan = SSDScan()


# One pass at a time (not counted: the path launches the three together
# through ``ssd_scan``). On the CPU each runs its plain pass on the input
# padded to whole chunks.

def chunk_states(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b_mat: torch.Tensor, *, chunk: int = 128):
    """Pass A: (states (B, NC, H, N, P), decays (B, NC, H)), float32 (see
    ``ref.ssd_chunk_states``)."""
    _check(x, dt, a, b_mat, b_mat, chunk)
    if _device(x) == "cpu":
        xp, dtp, bp, _ = pad_to_chunks(x, dt, b_mat, b_mat, chunk)
        return ssd_chunk_states(xp, dtp, a, bp, chunk)
    _check_kernel(x, a, b_mat, b_mat, chunk)
    states, decay = _scratch(x, b_mat, chunk)
    from repro_torch.kernels.ssd_scan.kernel import STATES, launch
    launch(x, dt, a, b_mat, b_mat, x, states, decay, chunk=chunk,
           route=kernel_route(x.dtype, chunk, b_mat.shape[3], x.shape[3]),
           passes=STATES)
    return states, decay


def state_passing(states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """Pass B: the state before each chunk, (B, NC, H, N, P) float32 (see
    ``ref.ssd_state_passing``); ``states`` is left as it is."""
    if states.dim() != 5 or tuple(decay.shape) != tuple(states.shape[:3]) \
            or states.dtype != torch.float32 or decay.dtype != torch.float32 \
            or decay.device != states.device:
        raise ValueError(f"states must be float32 (B, NC, H, N, P) and "
                         f"decay (B, NC, H) on its device, got "
                         f"{tuple(states.shape)} {states.dtype}, "
                         f"{tuple(decay.shape)} {decay.dtype}")
    if _device(states) == "cpu":
        return ssd_state_passing(states, decay)
    from repro_torch.kernels.ssd_scan.kernel import launch_state_passing
    out = states.contiguous().clone()
    launch_state_passing(out, decay.contiguous())
    return out


def chunk_outputs(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b_mat: torch.Tensor, c_mat: torch.Tensor,
                  s_before: torch.Tensor, *, chunk: int = 128
                  ) -> torch.Tensor:
    """Pass C: y (B, L, H, P) in x's dtype from the state before each
    chunk (see ``ref.ssd_chunk_outputs``)."""
    _check(x, dt, a, b_mat, c_mat, chunk)
    B, L, H, P = x.shape
    want = (B, -(-L // chunk), H, b_mat.shape[3], P)
    if tuple(s_before.shape) != want or s_before.dtype != torch.float32 \
            or s_before.device != x.device:
        raise ValueError(f"s_before must be float32 {want} on {x.device}, "
                         f"got {tuple(s_before.shape)} {s_before.dtype}")
    if _device(x) == "cpu":
        padded = pad_to_chunks(x, dt, b_mat, c_mat, chunk)
        return ssd_chunk_outputs(padded[0], padded[1], a, *padded[2:],
                                 s_before, chunk)[:, :L]
    _check_kernel(x, a, b_mat, c_mat, chunk)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    s = s_before.contiguous()
    from repro_torch.kernels.ssd_scan.kernel import OUTPUTS, launch
    launch(x, dt, a, b_mat, c_mat, y, s, s, chunk=chunk,
           route=kernel_route(x.dtype, chunk, b_mat.shape[3], P),
           passes=OUTPUTS)
    return y
