"""The fused SGD CUDA kernel against its plain PyTorch version, on the card.

Needs a CUDA device and the CUDA toolkit; imports no JAX, so it runs on a
GPU machine without the JAX package's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_fused_sgd_gpu.py

Without a card every case skips. The kernel rounds each multiply and add
explicitly, in the plain version's order, so the two must be equal bit for
bit. The gradient is also given as a list of leaves, read in place, in
each class of alignment between p and a leaf (sharing 16 bytes, 8 bytes,
4 bytes), with the span a block updates forced through ``kernel.launch``
(every block one 16-byte slot, a few slots, more than a segment) as well
as the kernel's default; and at the full-width paper CNN's ten leaves
with 1, 5 and 20 lanes (the FedSR rings and the FedAvg cohort). The
bfloat16 case (its own entry point, rounding after every operation) is
held bit for bit the same way: every leaf layout, forced spans of one
8-element slot, a few and more than a segment, p and m off their 16-byte
grid, and yi-9b's 2-layer training shape.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.fused_sgd import kernel
from repro_torch.kernels.fused_sgd.ops import fused_sgd_lanes
from repro_torch.kernels.fused_sgd.ref import sgd_lanes_reference

# leaf layouts, by how each leaf's rows sit against p's 16-byte grid
LAYOUTS = {
    # every offset and size a multiple of 4: p and g share 16 bytes
    "share16": [(64,), (16, 40), (8,)],
    # the big leaf two floats off p's grid in every lane: 8 bytes
    "share8": [(2,), (16, 40), (6,)],
    # the big leaf one float off: 4 bytes
    "share4": [(1,), (16, 40), (3,)],
    # the paper MLP's sorted layout (lanes alternate 16 and 8 bytes in w0)
    "mlp": [(200,), (200,), (10,), (784, 200), (200, 200), (200, 10)],
    # the paper CNN's sorted layout, 319,178 parameters (lanes alternate 16
    # and 8 bytes from fc1_b, a 10-float leaf, on)
    "cnn": [(32,), (3, 3, 3, 32), (64,), (3, 3, 32, 64), (64,),
            (3, 3, 64, 64), (64,), (4096, 64), (10,), (64, 10)],
    # odd sizes at odd offsets
    "odd": [(3,), (1,), (7, 5), (2,), (13,), (1,), (33,)],
}
MASKS = ((True,) * 5, (True, False, True, True, False), (False,) * 5)
STEPS = ((0.9, False), (0.9, True), (0.0, False))


def _split(g, shapes):
    """Contiguous leaves holding g's columns in order (fresh allocations,
    as autograd's are)."""
    out, off = [], 0
    for s in shapes:
        n = math.prod(s)
        out.append(g[:, off:off + n].clone(memory_format=torch.contiguous_format)
                   .view(g.shape[0], *s))
        off += n
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


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
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("span", [0, 4, 12, 4096])
@pytest.mark.parametrize("C", [1, 5])
def test_leaf_list_equals_plain_version_bit_for_bit(cuda, layout, span, C):
    shapes = LAYOUTS[layout]
    P = sum(math.prod(s) for s in shapes)
    gen = torch.Generator(device=cuda).manual_seed(P + C)
    p, g, m = (torch.randn(C, P, device=cuda, generator=gen)
               for _ in range(3))
    leaves = _split(g, shapes)
    lr = torch.tensor([0.02], device=cuda)
    for mask in MASKS:
        ok = torch.tensor(mask[:C], device=cuda)
        for reset in (False, True):
            for momentum, nesterov in STEPS:
                want = sgd_lanes_reference(p, leaves, m, ok, lr, reset=reset,
                                           momentum=momentum,
                                           nesterov=nesterov)
                pk, mk = p.clone(), m.clone()
                if span == 0:
                    before = fused_sgd_lanes.launches
                    fused_sgd_lanes(pk, leaves, mk, ok, lr, reset=reset,
                                    momentum=momentum, nesterov=nesterov)
                    assert fused_sgd_lanes.launches == before + 1
                else:
                    kernel.launch(pk, leaves, mk, ok, lr, reset=reset,
                                  momentum=momentum, nesterov=nesterov,
                                  span=span)
                torch.cuda.synchronize()
                assert torch.equal(pk, want[0]) and torch.equal(mk, want[1]), (
                    mask[:C], reset, momentum, nesterov)


@pytest.mark.gpu
@pytest.mark.parametrize("span", [0, 4, 4096])
def test_cnn_leaves_at_the_fedavg_cohort_of_20_lanes(cuda, span):
    C, shapes = 20, LAYOUTS["cnn"]
    P = sum(math.prod(s) for s in shapes)
    gen = torch.Generator(device=cuda).manual_seed(C + span)
    p, g, m = (torch.randn(C, P, device=cuda, generator=gen)
               for _ in range(3))
    leaves = _split(g, shapes)
    lr = torch.tensor([0.02], device=cuda)
    for mask in ([True] * C, [MASKS[1][i % 5] for i in range(C)],
                 [False] * C):
        ok = torch.tensor(mask, device=cuda)
        for reset in (False, True):
            want = sgd_lanes_reference(p, leaves, m, ok, lr, reset=reset,
                                       momentum=0.9)
            pk, mk = p.clone(), m.clone()
            if span == 0:
                before = fused_sgd_lanes.launches
                fused_sgd_lanes(pk, leaves, mk, ok, lr, reset=reset,
                                momentum=0.9)
                assert fused_sgd_lanes.launches == before + 1
            else:
                kernel.launch(pk, leaves, mk, ok, lr, reset=reset,
                              momentum=0.9, nesterov=False, span=span)
            torch.cuda.synchronize()
            assert torch.equal(pk, want[0]) and torch.equal(mk, want[1]), (
                mask, reset)


@pytest.mark.gpu
@pytest.mark.parametrize("off_p,off_m", [(1, 1), (2, 2), (0, 1), (3, 0)])
@pytest.mark.parametrize("span", [0, 4])
def test_p_and_m_off_the_16_byte_grid(cuda, off_p, off_m, span):
    """p starting off its 16-byte grid (heads in every segment), and p and
    m on different grids (every element alone)."""
    C, shapes = 3, LAYOUTS["mlp"][:4]
    P = sum(math.prod(s) for s in shapes)
    gen = torch.Generator(device=cuda).manual_seed(off_p * 4 + off_m)
    bp, bm = (torch.randn(C * P + 4, device=cuda, generator=gen)
              for _ in range(2))
    p, m = (b[o:o + C * P].view(C, P) for b, o in ((bp, off_p), (bm, off_m)))
    leaves = _split(torch.randn(C, P, device=cuda, generator=gen), shapes)
    ok = torch.tensor([True, False, True], device=cuda)
    lr = torch.tensor([0.02], device=cuda)
    for reset in (False, True):
        want = sgd_lanes_reference(p, leaves, m, ok, lr, reset=reset,
                                   momentum=0.9)
        pk = bp.clone()[off_p:off_p + C * P].view(C, P)
        mk = bm.clone()[off_m:off_m + C * P].view(C, P)
        kernel.launch(pk, leaves, mk, ok, lr, reset=reset, momentum=0.9,
                      nesterov=False, span=span)
        torch.cuda.synchronize()
        assert torch.equal(pk, want[0]) and torch.equal(mk, want[1])


@pytest.mark.gpu
def test_stack_of_more_than_65535_lanes(cuda):
    C, P = 65_536, 4
    gen = torch.Generator(device=cuda).manual_seed(11)
    p, g, m = (torch.randn(C, P, device=cuda, generator=gen)
               for _ in range(3))
    leaves = _split(g, [(1,), (3,)])
    ok = torch.rand(C, device=cuda, generator=gen) > 0.3
    lr = torch.tensor([0.02], device=cuda)
    want = sgd_lanes_reference(p, leaves, m, ok, lr, reset=False,
                               momentum=0.9)
    fused_sgd_lanes(p, leaves, m, ok, lr, reset=False, momentum=0.9)
    torch.cuda.synchronize()
    assert torch.equal(p, want[0]) and torch.equal(m, want[1])


@pytest.mark.gpu
def test_wrapper_never_waits_on_the_host(cuda):
    C, shapes = 5, LAYOUTS["mlp"]
    P = sum(math.prod(s) for s in shapes)
    gen = torch.Generator(device=cuda).manual_seed(3)
    p, g, m = (torch.randn(C, P, device=cuda, generator=gen)
               for _ in range(3))
    leaves = _split(g, shapes)
    ok = torch.ones(C, dtype=torch.bool, device=cuda)
    lr = torch.tensor([0.02], device=cuda)
    want = sgd_lanes_reference(p, leaves, m, ok, lr, reset=True,
                               momentum=0.9)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused_sgd_lanes(p, leaves, m, ok, lr, reset=True, momentum=0.9)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(p, want[0]) and torch.equal(m, want[1])


@pytest.mark.gpu
def test_cuda_tensor_never_falls_back_to_the_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = torch.zeros(2, 8, device="cuda")
    ok = torch.ones(2, dtype=torch.bool, device="cuda")
    lr = torch.tensor([0.1], device="cuda")
    with pytest.raises(ValueError):     # mixed devices: raise, not fall back
        fused_sgd_lanes(p, torch.zeros(2, 8), p.clone(), ok, lr, reset=False,
                        momentum=0.5)
    with pytest.raises(ValueError):     # a leaf the kernel cannot read in place
        fused_sgd_lanes(p, [torch.zeros(4, 2, device="cuda").t(),
                            torch.zeros(2, 4, device="cuda")], p.clone(), ok,
                        lr, reset=False, momentum=0.5)
    assert not p.any()


BF16_SPANS = [0, 8, 24, 4096]


def _bf16_case(cuda, C, shapes, seed):
    P = sum(math.prod(s) for s in shapes)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    p, g, m = (torch.randn(C, P, device=cuda, generator=gen).bfloat16()
               for _ in range(3))
    return p, _split(g, shapes), m, torch.tensor([0.3], device=cuda).bfloat16()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("span", BF16_SPANS)
@pytest.mark.parametrize("C", [1, 5])
def test_bf16_leaf_list_equals_plain_version_bit_for_bit(cuda, layout, span,
                                                         C):
    p, leaves, m, lr = _bf16_case(cuda, C, LAYOUTS[layout], C + span)
    for mask in MASKS:
        ok = torch.tensor(mask[:C], device=cuda)
        for reset in (False, True):
            for momentum, nesterov in STEPS + ((0.5, True),):
                want = sgd_lanes_reference(p, leaves, m, ok, lr, reset=reset,
                                           momentum=momentum,
                                           nesterov=nesterov)
                pk, mk = p.clone(), m.clone()
                if span == 0:
                    before = (fused_sgd_lanes.launches,
                              fused_sgd_lanes.bf16_launches)
                    fused_sgd_lanes(pk, leaves, mk, ok, lr, reset=reset,
                                    momentum=momentum, nesterov=nesterov)
                    assert (fused_sgd_lanes.launches,
                            fused_sgd_lanes.bf16_launches) == (
                        before[0] + 1, before[1] + 1)
                else:
                    kernel.launch(pk, leaves, mk, ok, lr, reset=reset,
                                  momentum=momentum, nesterov=nesterov,
                                  span=span)
                torch.cuda.synchronize()
                assert pk.dtype == mk.dtype == torch.bfloat16
                assert torch.equal(pk, want[0]) and torch.equal(mk, want[1]), (
                    mask[:C], reset, momentum, nesterov)


@pytest.mark.gpu
@pytest.mark.parametrize("off_p,off_m", [(1, 1), (3, 3), (0, 1), (5, 0)])
def test_bf16_p_and_m_off_the_16_byte_grid(cuda, off_p, off_m):
    C, shapes = 3, LAYOUTS["mlp"][:4]
    P = sum(math.prod(s) for s in shapes)
    gen = torch.Generator(device=cuda).manual_seed(off_p * 8 + off_m)
    bp, bm = (torch.randn(C * P + 8, device=cuda, generator=gen).bfloat16()
              for _ in range(2))
    p, m = (b[o:o + C * P].view(C, P) for b, o in ((bp, off_p), (bm, off_m)))
    leaves = _split(torch.randn(C, P, device=cuda, generator=gen).bfloat16(),
                    shapes)
    ok = torch.tensor([True, False, True], device=cuda)
    lr = torch.tensor([0.02], device=cuda).bfloat16()
    for reset in (False, True):
        want = sgd_lanes_reference(p, leaves, m, ok, lr, reset=reset,
                                   momentum=0.9)
        pk = bp.clone()[off_p:off_p + C * P].view(C, P)
        mk = bm.clone()[off_m:off_m + C * P].view(C, P)
        fused_sgd_lanes(pk, leaves, mk, ok, lr, reset=reset, momentum=0.9)
        torch.cuda.synchronize()
        assert torch.equal(pk, want[0]) and torch.equal(mk, want[1])


@pytest.mark.gpu
def test_bf16_at_yi_9b_two_layer_training_shape(cuda):
    """(1, 870,338,560) over yi-9b's twelve leaves, as phase 9 (d) of
    ``chip_smoke.py`` steps it."""
    from repro_torch.configs.yi_9b import CONFIG
    from repro_torch.launch.steps import train_layout
    import dataclasses

    shapes = [s for _, s in train_layout(dataclasses.replace(CONFIG,
                                                             num_layers=2))]
    p, leaves, m, lr = _bf16_case(cuda, 1, shapes, 9)
    ok = torch.ones(1, dtype=torch.bool, device=cuda)
    want = sgd_lanes_reference(p, leaves, m, ok, lr, reset=False,
                               momentum=0.5)
    fused_sgd_lanes(p, leaves, m, ok, lr, reset=False, momentum=0.5)
    torch.cuda.synchronize()
    assert torch.equal(p, want[0]) and torch.equal(m, want[1])
