"""The SSD-scan CUDA kernel against its plain PyTorch version, on the card.

Needs a CUDA device and the CUDA toolkit; imports no JAX, so it runs on a
GPU machine without the JAX package's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ssd_scan_gpu.py

Without a card every case skips. The kernel sums the chunk's products in
another order than the plain version, so the two agree within 1e-5 of the
output scale in float32 and 1e-2 in bfloat16 (one rounding of y to
bfloat16), the bounds of ``tests/test_torch_ssd_scan.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

# (b, l, h, g, p, n, chunk): tests/test_kernels.py's sweep, ragged lengths,
# and mamba2-2.7b's prefill shape (G=1, H=80, P=64, N=Q=128, S=4096)
SWEEP = [
    (2, 64, 4, 1, 16, 8, 16),
    (1, 96, 8, 2, 32, 16, 32),
    (2, 50, 4, 1, 16, 8, 16),
    (1, 128, 4, 4, 64, 32, 64),
    (1, 100, 4, 2, 16, 8, 32),
    (1, 200, 8, 1, 64, 128, 128),
    (1, 4096, 80, 1, 64, 128, 128),
]


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
    out = ssd_scan(*args, chunk=shape[-1])
    assert ssd_scan.launches == before + 1
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
