"""The fused SGD CUDA kernel against its plain PyTorch version, on the card.

Needs a CUDA device and the CUDA toolkit; imports no JAX, so it runs on a
GPU machine without the JAX package's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_fused_sgd_gpu.py

Without a card every case skips. The kernel rounds each multiply and add
explicitly, in the plain version's order, so the two must be equal bit for
bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.fused_sgd.ops import fused_sgd_lanes
from repro_torch.kernels.fused_sgd.ref import sgd_lanes_reference


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 255, 257, 1023, 4097, 199_210])
@pytest.mark.parametrize("nesterov", [False, True])
def test_cuda_kernel_equals_plain_version(n, nesterov):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    C = 5
    rng = np.random.default_rng(n)
    p, g, m = (torch.from_numpy(rng.standard_normal((C, n)).astype(np.float32))
               .cuda() for _ in range(3))
    ok = torch.tensor([True, False, True, True, False], device="cuda")
    lr = torch.tensor([0.02], device="cuda")
    for reset in (True, False):
        want = sgd_lanes_reference(p, g, m, ok, lr, reset=reset,
                                   momentum=0.9, nesterov=nesterov)
        pk, mk = p.clone(), m.clone()
        before = fused_sgd_lanes.launches
        fused_sgd_lanes(pk, g, mk, ok, lr, reset=reset, momentum=0.9,
                        nesterov=nesterov)
        torch.cuda.synchronize()
        assert fused_sgd_lanes.launches == before + 1
        assert torch.equal(pk, want[0]) and torch.equal(mk, want[1])


@pytest.mark.gpu
def test_cuda_tensor_never_falls_back_to_the_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = torch.zeros(2, 8, device="cuda")
    with pytest.raises(ValueError):     # mixed devices: raise, not fall back
        fused_sgd_lanes(p, torch.zeros(2, 8), p.clone(),
                        torch.ones(2, dtype=torch.bool, device="cuda"),
                        torch.tensor([0.1], device="cuda"), reset=False,
                        momentum=0.5)
