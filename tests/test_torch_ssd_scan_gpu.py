"""The SSD-scan CUDA kernel against its plain PyTorch version, on the card.

Needs a CUDA device and the CUDA toolkit; imports no JAX, so it runs on a
GPU machine without the JAX package's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ssd_scan_gpu.py

Without a card every case skips. The kernel sums the chunk's products in
another order than the plain version, so the two agree within 1e-5 of the
output scale in float32 and 1e-2 in bfloat16 (one rounding of y to
bfloat16), the bounds of ``tests/test_torch_ssd_scan.py``. Each of the
kernel's three passes is also held against its plain pass (the states
within ``chip_smoke.SSD_STATE_TOL`` of their scale), and the bfloat16
route against ``chip_smoke.py``'s split probes: each float32 operand that
it multiplies on the tensor cores (the decayed scores, the chunk state's
w x, S_{c-1}) reaches the product as bfloat16 hi + lo.
"""
import functools
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.ssd_scan.ops import (
    kernel_route, ssd_scan, ssd_scan_plain,
)

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

# (b, l, h, g, p, n, chunk): tests/test_kernels.py's sweep, ragged lengths,
# and mamba2-2.7b's prefill shape (G=1, H=80, P=64, N=Q=128, S=4096); then
# what the three passes and the routes meet: two batch rows of two groups
# across 34 chunks with L = 33 Q + 1, L < Q, the tensor-core route at
# chunk 64 (N = 64: one box), the model's head shape at chunks 16 and
# 32 (the CUDA-core route in bfloat16 too), and jamba-v0.1-52b's prefill
# (H=128, N=16 at chunk 128: the tensor-core route in bfloat16, 48 of the
# box's 64 columns zero fill) with a ragged N = 16 case beside it
SWEEP = [
    (2, 64, 4, 1, 16, 8, 16),
    (1, 96, 8, 2, 32, 16, 32),
    (2, 50, 4, 1, 16, 8, 16),
    (1, 128, 4, 4, 64, 32, 64),
    (1, 100, 4, 2, 16, 8, 32),
    (1, 200, 8, 1, 64, 128, 128),
    (1, 4096, 80, 1, 64, 128, 128),
    (2, 4225, 8, 2, 64, 128, 128),
    (1, 100, 8, 1, 64, 128, 128),
    (2, 1000, 8, 2, 64, 64, 64),
    (1, 200, 4, 1, 64, 128, 32),
    (1, 160, 4, 1, 64, 128, 16),
    (1, 4096, 128, 1, 64, 16, 128),    # jamba-v0.1-52b's prefill
    (2, 300, 8, 2, 64, 16, 128),       # N = 16 at chunk 128, ragged, G=2
]
PATH = (1, 4096, 80, 1, 64, 128, 128)
JAMBA = (1, 4096, 128, 1, 64, 16, 128)


@functools.cache
def _smoke():
    """``chip_smoke.py``, for its split probes and state bound."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = smoke         # its dataclass looks itself up
    try:
        spec.loader.exec_module(smoke)
    finally:
        del sys.modules[spec.name]
    return smoke


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, device, strided, seed=0):
    """Seeded x, dt, a, B, C; with ``strided`` x, B and C are column slices
    of one (b, l, h*p + 2*g*n) buffer, the model's layout."""
    b, l, h, g, p, n, _ = shape
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=dt)
    if strided:
        buf = rng.standard_normal((b, l, h * p + 2 * g * n))
        buf[..., h * p:] *= 0.3
        xbc = t(buf, dtype)
        x = xbc[..., :h * p].reshape(b, l, h, p)
        bm = xbc[..., h * p:h * p + g * n].reshape(b, l, g, n)
        cm = xbc[..., h * p + g * n:].reshape(b, l, g, n)
    else:
        x = t(rng.standard_normal((b, l, h, p)), dtype)
        bm = t(rng.standard_normal((b, l, g, n)) * 0.3, dtype)
        cm = t(rng.standard_normal((b, l, g, n)) * 0.3, dtype)
    dt = t(np.abs(rng.standard_normal((b, l, h))) * 0.5 + 0.01)
    a = t(-np.abs(rng.standard_normal(h)) - 0.1)
    return x, dt, a, bm, cm


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SWEEP)
def test_ssd_kernel_matches_plain_version(cuda, shape, dtype, strided):
    args = _inputs(shape, dtype, cuda, strided, seed=shape[1])
    before = ssd_scan.launches
    route = kernel_route(dtype, shape[-1], shape[5], shape[4])
    routed = ssd_scan.routes[route]
    out = ssd_scan(*args, chunk=shape[-1])
    assert ssd_scan.launches == before + 1
    assert ssd_scan.routes[route] == routed + 1
    want = ssd_scan_plain(*args, chunk=shape[-1])
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == want.shape
    assert out.is_contiguous()
    scale = max(want.float().abs().max().item(), 1e-6)
    err = (out.float() - want.float()).abs().max().item() / scale
    assert err <= TOL[dtype], err


@pytest.mark.gpu
def test_ssd_kernel_raises_on_what_it_does_not_take(cuda):
    x, dt, a, bm, cm = _inputs((1, 64, 4, 1, 16, 8, 16), torch.float32,
                               cuda, False)
    before = ssd_scan.launches
    with pytest.raises(ValueError):
        ssd_scan(x, dt, a, bm, cm, chunk=256)            # chunk > 128
    with pytest.raises(ValueError):
        ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, a, bm,
                 cm, chunk=16)                           # strided last dim
    with pytest.raises(ValueError):
        ssd_scan(x, dt, a, bm.cpu(), cm, chunk=16)       # mixed devices
    assert ssd_scan.launches == before


@pytest.mark.gpu
def test_path_shape_in_bfloat16_takes_the_tensor_core_route(cuda):
    args = _inputs(PATH, torch.bfloat16, cuda, True)
    before = ssd_scan.routes["tensor_cores"]
    ssd_scan(*args, chunk=PATH[-1])
    torch.cuda.synchronize()
    assert ssd_scan.routes["tensor_cores"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [JAMBA, (2, 300, 8, 2, 64, 16, 128)])
def test_n16_at_chunk_128_in_bfloat16_takes_the_tensor_core_route(cuda,
                                                                  shape):
    """jamba's N = 16: one 64-column box of B and C, 48 of its columns
    zero fill; the route is the tensor cores', never the CUDA cores'."""
    assert kernel_route(torch.bfloat16, shape[-1], shape[5],
                        shape[4]) == "tensor_cores"
    args = _inputs(shape, torch.bfloat16, cuda, True, seed=shape[1])
    before = ssd_scan.routes.copy()
    out = ssd_scan(*args, chunk=shape[-1])
    want = ssd_scan_plain(*args, chunk=shape[-1])
    torch.cuda.synchronize()
    assert ssd_scan.routes["tensor_cores"] == before["tensor_cores"] + 1
    assert ssd_scan.routes["cuda_cores"] == before["cuda_cores"]
    assert _rel(out, want) <= TOL[torch.bfloat16]


def _rel(got, want):
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1024, 8, 2, 64, 128, 128),
                                   (1, 512, 4, 1, 64, 64, 64),
                                   (1, 256, 4, 2, 16, 8, 32)])
def test_each_pass_matches_its_plain_pass(cuda, shape, dtype):
    """Each pass fed the plain previous pass's output (L a multiple of the
    chunk, as the plain passes take it): chunk states and decays, the
    states before each chunk, the outputs."""
    q = shape[-1]
    x, dt, a, bm, cm = _inputs(shape, dtype, cuda, True, seed=3)
    states, decay = ssd_ref.ssd_chunk_states(x, dt, a, bm, q)
    got_states, got_decay = ssd_ops.chunk_states(x, dt, a, bm, chunk=q)
    before = ssd_ref.ssd_state_passing(states, decay)
    got_before = ssd_ops.state_passing(states, decay)
    y = ssd_ops.chunk_outputs(x, dt, a, bm, cm, before, chunk=q)
    want = ssd_ref.ssd_chunk_outputs(x, dt, a, bm, cm, before, q)
    torch.cuda.synchronize()
    tol = _smoke().SSD_STATE_TOL
    assert _rel(got_states, states) <= tol
    assert _rel(got_decay, decay) <= tol
    assert _rel(got_before, before) <= tol
    assert y.dtype == dtype and _rel(y, want) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("kind", ["scores", "states", "s_before"])
def test_bfloat16_route_splits_each_float32_operand(cuda, kind, chunk):
    """ROADMAP C4 on the tensor cores: on each probe the operand rounded
    to bfloat16 alone would be 400% off the exact output; hi + lo is
    within ``SSD_SPLIT_TOL``."""
    smoke = _smoke()
    args, rows, exact, _ = smoke.ssd_probe(kind, chunk, cuda)
    assert kernel_route(torch.bfloat16, chunk, 128, 64) == "tensor_cores"
    before = ssd_scan.launches
    y = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert smoke.ssd_split_err(y, rows, exact) <= smoke.SSD_SPLIT_TOL
