"""The flash attention's training route on the card: the backward kernel
(``csrc/flash_attention_bwd.cu``) and the forward's ``lse`` output against
their plain PyTorch versions, ``FlashAttentionFn`` against autograd of the
plain version, and the LM train step's kernels.

Needs a CUDA device and the CUDA toolkit; imports no JAX, so it runs on a
GPU machine without the JAX package's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_flash_grad_gpu.py

Without a card every case skips. The float32 cases cross the 32-row tiles
of the CUDA-core kernels (ragged S, windows starting inside a tile, G up to
8) at every hd they take. Tolerances: each gradient against the
plain backward computed in float64 from the same inputs, relative to the
largest |value| of that gradient: ``TOL[float32]`` = 1e-4 (float32 sums
over up to S keys in another order) and ``TOL[bfloat16]`` = 2e-2 (one
bfloat16 rounding of each output, 2**-8, with P rebuilt from the
tensor-core forward's ``lse``); ``lse`` within 1e-4 absolute of the plain
one in both types (it is computed in float32 from the same inputs). In
float32, rows whose softmax has saturated to one-hot give the plain
version's exact zero dS, so their gradients agree at the same bound.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ops import (
    flash_attention, flash_attention_bwd, flash_attention_lse,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_lse_plain, flash_attention_bwd_plain,
)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, s, h, kv, hd, dtype, device, seed=0):
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=dtype)
    return (randn(b, s, h, hd), randn(b, s, kv, hd), randn(b, s, kv, hd),
            randn(b, s, h, hd))


def _rel(got, want) -> float:
    want = want.double()
    return float((got.double() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


CASES = [  # b, s, h, kv, hd, causal, window
    (2, 64, 4, 2, 32, True, 0),
    (1, 100, 4, 2, 64, True, 0),         # ragged S
    (1, 257, 8, 1, 128, True, 0),        # MQA, one row past 4 tiles
    (2, 130, 4, 4, 160, True, 0),        # hd 160
    (1, 256, 8, 2, 64, True, 48),        # a window that starts in a tile
    (1, 200, 4, 1, 32, True, 100),
    (2, 96, 4, 2, 64, False, 0),         # no mask
    (1, 80, 2, 2, 128, False, 30),       # a window without causality
    (4, 256, 10, 10, 64, True, 0),       # fedsr-lm-100m's lane
    (1, 1024, 32, 4, 128, True, 0),      # yi-9b's GQA: 8 key tiles, G = 8
    (1, 512, 32, 8, 160, True, 0),       # stablelm's hd 160 with G = 4
    (1, 300, 16, 2, 64, True, 100),      # ragged, G = 8, a window
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", CASES)
def test_backward_kernel_matches_the_plain_version(cuda, b, s, h, kv, hd,
                                                   causal, window, dtype):
    q, k, v, do = _inputs(b, s, h, kv, hd, dtype, cuda)
    out, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(
        lse, attention_lse_plain(q, k, causal=causal, window=window),
        rtol=0, atol=LSE_TOL)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, do, lse, causal=causal,
                              window=window)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    exact = flash_attention_bwd_plain(q, k, v, do, causal=causal,
                                      window=window, dtype=torch.float64)
    for g, e, name in zip(got, exact, "qkv"):
        assert g.dtype == dtype and g.shape == e.shape
        assert _rel(g, e) <= TOL[dtype], (name, _rel(g, e))
    # deterministic: no atomics, so a rerun gives the same bits
    again = flash_attention_bwd(q, k, v, do, lse, causal=causal,
                                window=window)
    for a, g in zip(again, got):
        assert torch.equal(a, g)


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [3e3, 3e5])
def test_saturated_rows_give_the_plain_gradient(cuda, scale):
    """Scores near 1e8 and 1e12 (the reference's LM reaches such scores
    within a few steps at learning rate 0.3): one-hot softmax rows, whose
    dS autograd makes exactly 0; the kernel's D is the sum of its own
    P dP, so it does too, where a rowsum(dO * O) would leave a residue
    that the huge K multiplies. (Scores near 1e4 leave near-ties whose
    rounding the huge K amplifies in both versions alike; they are not
    this check's case.)"""
    q, k, v, do = _inputs(2, 192, 4, 2, 64, torch.float32, cuda, seed=3)
    q, k = q * scale, k * scale
    out, lse = flash_attention_lse(q, k, v, causal=True, window=0)
    got = flash_attention_bwd(q, k, v, do, lse)
    want = flash_attention_bwd_plain(q, k, v, do)
    for g, w in zip(got, want):
        assert bool(g.isfinite().all())
        bound = TOL[torch.float32] * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= bound


SATURATED = [  # b, s, h, kv, hd, window
    (2, 192, 4, 2, 64, 48),      # a window that starts inside a tile
    (1, 256, 8, 1, 64, 0),       # G = 8
    (1, 100, 4, 2, 64, 0),       # ragged S
    (1, 150, 8, 1, 128, 40),     # hd 128: ragged, G = 8, a window
    (2, 130, 4, 2, 160, 0),      # hd 160, ragged
]


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [3e3, 3e5])
@pytest.mark.parametrize("b,s,h,kv,hd,window", SATURATED)
def test_saturated_rows_with_windows_gqa_and_ragged_rows(cuda, b, s, h, kv,
                                                         hd, window, scale):
    """The saturated rows of ``test_saturated_rows_give_the_plain_gradient``
    at the float32 tiling's edges: a window's first tile, eight query heads
    summed into one kv head's dK and dV, rows past S in the last tile, and
    the larger head dims. The backward rebuilds the forward's score bits
    from the shared chain, so each one-hot row's dS is exactly 0."""
    q, k, v, do = _inputs(b, s, h, kv, hd, torch.float32, cuda, seed=4)
    q, k = q * scale, k * scale
    out, lse = flash_attention_lse(q, k, v, causal=True, window=window)
    got = flash_attention_bwd(q, k, v, do, lse, causal=True, window=window)
    want = flash_attention_bwd_plain(q, k, v, do, causal=True, window=window)
    for g, w in zip(got, want):
        assert bool(g.isfinite().all())
        bound = TOL[torch.float32] * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= bound


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 256, 32, 4, 128), (1, 192, 32, 8, 160),
                                   (2, 100, 4, 2, 64)])
def test_forward_output_is_the_same_with_and_without_lse(cuda, shape, dtype):
    b, s, h, kv, hd = shape
    q, k, v, _ = _inputs(b, s, h, kv, hd, dtype, cuda, seed=1)
    with torch.no_grad():
        plain = flash_attention(q, k, v)
    out, _ = flash_attention_lse(q, k, v, causal=True, window=0)
    assert torch.equal(out, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_launches_both_kernels(cuda, dtype):
    q, k, v, do = _inputs(2, 128, 8, 2, 64, dtype, cuda, seed=2)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(*leaves, causal=True, window=16)
    assert "FlashAttentionFn" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, do)
    assert flash_attention.launches == f0 + 1
    assert flash_attention_bwd.launches == b0 + 1
    plain_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(
        *plain_leaves, causal=True, window=16), plain_leaves, do)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL[dtype]


@pytest.mark.gpu
def test_backward_rejects_other_key_lengths(cuda):
    q, k, v, do = _inputs(1, 64, 2, 1, 32, torch.float32, cuda)
    out, lse = flash_attention_lse(q, k, v, causal=True, window=0)
    kk, vv = torch.cat([k, k], 1), torch.cat([v, v], 1)
    with pytest.raises(ValueError, match="T == S"):
        flash_attention_bwd(q, kk, vv, do, lse)
    with pytest.raises(ValueError, match="hd in"):
        ops._check_cuda("flash_attention_bwd", q=q[..., :16])


@pytest.mark.gpu
def test_backward_rejects_a_misaligned_bfloat16_view(cuda):
    """The bfloat16 kernels load q, k, v and dout with TMA, which reads
    from 16-byte aligned addresses only: a contiguous view one element
    into its storage raises instead of launching."""
    q, k, v, do = _inputs(1, 64, 4, 2, 64, torch.bfloat16, cuda)
    out, lse = flash_attention_lse(q, k, v, causal=True, window=0)
    shifted = torch.empty(do.numel() + 1, dtype=do.dtype,
                          device=cuda)[1:].view(do.shape)
    shifted.copy_(do)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = flash_attention_bwd.launches
    with pytest.raises(ValueError, match="dout must be 16-byte aligned"):
        flash_attention_bwd(q, k, v, shifted, lse)
    assert flash_attention_bwd.launches == before


@pytest.mark.gpu
def test_float32_kernels_reject_a_misaligned_view(cuda):
    """The float32 kernels copy q, k, v and dout with 16-byte cp.async: a
    contiguous view one element into its storage raises instead of
    launching, in the forward and in the backward."""
    q, k, v, do = _inputs(1, 64, 4, 2, 64, torch.float32, cuda)
    out, lse = flash_attention_lse(q, k, v, causal=True, window=0)
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    with pytest.raises(ValueError, match="q must be 16-byte aligned"):
        flash_attention(shifted, k, v)
    with pytest.raises(ValueError, match="q must be 16-byte aligned"):
        flash_attention_bwd(shifted, k, v, do, lse)
    assert (flash_attention.launches, flash_attention_bwd.launches) == (f0, b0)


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_lm_train_step_runs_the_kernels(cuda, fused):
    import dataclasses

    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels.fused_sgd.ops import fused_sgd_lanes
    from repro_torch.launch.steps import make_train_step, train_layout
    from repro_torch.launch.train import lm_100m_config
    from repro_torch.models.transformer import init_model
    from repro_torch.utils.tree import flatten_tree

    cfg = dataclasses.replace(lm_100m_config(), num_layers=2, d_model=128,
                              d_ff=256, num_heads=2, num_kv_heads=2,
                              vocab_size=256)
    base = flatten_tree(init_model(torch.Generator().manual_seed(0), cfg,
                                   cuda))
    flat = torch.cat([base[k].reshape(-1) for k, _ in train_layout(cfg)])
    state = {"params": flat.expand(2, -1).contiguous(),
             "mom": torch.zeros(2, flat.numel(), device=cuda), "step": 0}
    toks = torch.randint(0, 256, (2, 2, 65), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    batch = {"inputs": toks[..., :-1], "labels": toks[..., 1:]}
    step, _ = make_train_step(cfg, TrainConfig(learning_rate=0.1,
                                               fused_sgd=fused))
    counts = (flash_attention.launches, flash_attention_bwd.launches,
              fused_sgd_lanes.launches)
    state, loss = step(state, batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    assert flash_attention.launches - counts[0] == 2 * 2   # layers x lanes
    assert flash_attention_bwd.launches - counts[1] == 2 * 2
    assert fused_sgd_lanes.launches - counts[2] == int(fused)
