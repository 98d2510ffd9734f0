"""The flash- and decode-attention CUDA kernels against their plain
PyTorch versions, on the card.

Needs a CUDA device and the CUDA toolkit; imports no JAX, so it runs on a
GPU machine without the JAX package's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_attention_gpu.py

Without a card every case skips, except the check that the C3 probe of
``chip_smoke.py`` tells float32 P from bfloat16 P, which needs no kernel.
Decode attention is also run with its split count forced through
``kernel.launch`` (both the one-kernel route, S = 1, and split + combine),
over split boundaries, empty splits and windows that cross splits.
Online softmax sums in another order than the plain version, so the two
agree within 1e-5 in float32 and 2e-2 in bfloat16 (one rounding of the
output), the bounds of ``tests/test_kernels.py``; each bfloat16 flash row
also within ``chip_smoke.FLASH_ROW_TOL`` of its largest value.
"""
import functools
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_plain, split_scratch,
)
from repro_torch.kernels.flash_attention.ops import (
    flash_attention, flash_attention_plain,
)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
DECODE_DTYPES = [(torch.float32, torch.float32),
                 (torch.bfloat16, torch.bfloat16),
                 (torch.bfloat16, torch.float32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        device=device, dtype=dtype)


@functools.cache
def _smoke():
    """``chip_smoke.py``, for its C3 probe and row bound."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = smoke         # its dataclass looks itself up
    try:
        spec.loader.exec_module(smoke)
    finally:
        del sys.modules[spec.name]
    return smoke


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,t,h,kv,hd,window,causal", [
    (2, 64, 64, 4, 2, 32, 0, True),
    (1, 128, 128, 8, 8, 64, 0, True),
    (2, 64, 64, 4, 1, 32, 0, True),       # MQA
    (1, 256, 256, 4, 2, 128, 0, True),
    (1, 128, 128, 4, 2, 32, 16, True),
    (1, 128, 128, 4, 2, 32, 48, True),
    (1, 128, 128, 4, 2, 32, 100, True),
    (1, 1000, 1000, 8, 2, 64, 0, True),   # ragged S
    (1, 1000, 1000, 8, 2, 64, 300, True),
    (2, 64, 64, 4, 2, 32, 0, False),
    (1, 256, 256, 32, 4, 128, 0, True),   # yi-9b heads
    # the 128-row, TMA-fed bfloat16 tiling: ragged S at the path's head
    # dim, G = 8 over two batch rows (the 4-D tensor maps keep them
    # apart), a window edge inside a 128-row tile, non-causal T > S
    (1, 200, 200, 8, 2, 128, 0, True),
    (1, 1000, 1000, 8, 2, 128, 0, True),
    (2, 384, 384, 32, 4, 128, 0, True),
    (1, 1000, 1000, 8, 2, 128, 200, True),
    (2, 64, 320, 4, 2, 128, 0, False),
    # hd 160 (stablelm-12b): five 32-column boxes a tile under the 64 B
    # swizzle, an n160 PV product; its heads, ragged S, a window edge
    # inside a tile, non-causal T > S with a ragged T tile
    (1, 512, 512, 32, 8, 160, 0, True),
    (1, 1000, 1000, 8, 2, 160, 0, True),
    (1, 1000, 1000, 8, 2, 160, 200, True),
    (2, 64, 320, 4, 2, 160, 0, False),
    # the audio and vlm prefills: musicgen-large's MHA at hd 64, llava's
    # GQA at S = 8192 under its 4096-key window, which binds
    (1, 4096, 4096, 32, 32, 64, 0, True),
    (1, 8192, 8192, 32, 8, 128, 4096, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(cuda, b, s, t, h, kv, hd, window,
                                            causal, dtype):
    rng = np.random.default_rng(s + h + window)
    q = _randn(rng, (b, s, h, hd), dtype, cuda)
    k = _randn(rng, (b, t, kv, hd), dtype, cuda)
    v = _randn(rng, (b, t, kv, hd), dtype, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype and out.shape == q.shape
    err = (out.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err
    if dtype == torch.bfloat16:
        row = _smoke().row_err(out, want)
        assert row <= _smoke().FLASH_ROW_TOL, row


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [32, 64, 128, 160])
def test_flash_kernel_keeps_probabilities_in_float32(cuda, hd):
    """ROADMAP C3: the bfloat16 kernel feeds P to the PV product as
    bfloat16 hi + lo, never rounded alone; on the probe, bfloat16 P would
    be off by 400% of the exact output."""
    smoke = _smoke()
    q, k, v, exact, _ = smoke.c3_probe(hd, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert smoke.c3_err(out, exact) <= smoke.C3_TOL


@pytest.mark.parametrize("hd", [32, 64, 128, 160])
def test_c3_probe_tells_float32_p_from_bfloat16_p(hd):
    """On the CPU the wrapper runs the plain version, whose P is float32:
    it meets the probe's bound, and the output bfloat16 P gives does not."""
    smoke = _smoke()
    q, k, v, exact, rounded = smoke.c3_probe(hd, torch.device("cpu"))
    out = flash_attention(q, k, v, causal=False)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert smoke.c3_err(out, exact) <= smoke.C3_TOL
    assert abs(rounded - exact) / abs(exact) > 10 * smoke.C3_TOL


def test_ptxas_report_names_the_float32_flash_kernels():
    """``chip_smoke.py``'s phase-1 check reads the float32 (``simt::``)
    flash kernels by label: the forward, the backward's D kernel and its
    dq-and-dkdv kernel, each with its head dim; a spill shows in the
    report that the check holds."""
    smoke = _smoke()
    pre = "_ZN47_GLOBAL__N__8c21e4aa_22_flash_attention_bwd_cu_5f0d6e2b"
    labels = {
        pre + "4simt22flash_bwd_delta_kernelILi64EEEvPKfS3_S3_S3_S3_Pfiiiiiif":
        "simt::flash_bwd_delta_kernel<64>",
        pre + "4simt21flash_bwd_grad_kernelILi160EEEvPKfS3_S3_S3_S3_PfS4_S4_"
        "S4_iiiiiiffii": "simt::flash_bwd_grad_kernel<160>",
        pre + "2tc19flash_bwd_dq_kernelILi128EEEv14CUtensorMap_st":
        "tc::flash_bwd_dq_kernel<128>",
        "_ZN47_GLOBAL__N__0b1d_18_flash_attention_cu_9a4simt22flash_"
        "attention_kernelILi32EEEvPKfS3_S3_PfS4_iiiiiif":
        "simt::flash_attention_kernel<32>"}
    for mangled, label in labels.items():
        assert smoke.kernel_label(mangled) == label
    grad = next(iter(k for k in labels if "grad" in k))
    log = (f"ptxas info    : Compiling entry function '{grad}' for 'sm_90a'\n"
           f"    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill "
           f"loads\n"
           f"ptxas info    : Used 128 registers, used 1 barriers\n")
    assert smoke.ptxas_by_kernel(log) == {
        "simt::flash_bwd_grad_kernel<160>": "128 registers, 8 bytes spill "
        "stores, 8 bytes spill loads; injected wgmma none"}
    assert {k for ks in smoke.SIMT_KERNELS.values() for k in ks} == {
        "flash_attention_kernel", "flash_bwd_delta_kernel",
        "flash_bwd_grad_kernel"}


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kv,t,hd,window", [
    (2, 8, 2, 256, 32, 0),
    (2, 8, 2, 256, 32, 100),
    (1, 4, 4, 512, 64, 0),
    (1, 4, 4, 512, 64, 100),
    (3, 8, 1, 128, 128, 0),               # MQA
    (3, 8, 1, 128, 128, 100),
    (4, 32, 4, 48, 128, 0),               # yi-9b serving default
    (2, 32, 2, 300, 128, 0),              # G = 16
    (4, 32, 8, 48, 160, 0),               # stablelm-12b serving default
    (3, 8, 1, 128, 160, 100),             # hd 160, MQA, window
    (4, 32, 32, 48, 128, 0),              # deepseek-7b serving default (G = 1)
    (4, 32, 8, 48, 128, 0),               # granite-8b's and llava's
    (4, 32, 32, 48, 64, 0),               # musicgen-large (G = 1, hd 64)
    (2, 32, 8, 8448, 128, 4096),          # llava's window binding
])
@pytest.mark.parametrize("qd,cd", DECODE_DTYPES)
@pytest.mark.parametrize("edge", [None, "one", "full"])
def test_decode_kernel_matches_plain_version(cuda, b, h, kv, t, hd, window,
                                             qd, cd, edge):
    rng = np.random.default_rng(b + t + hd + window)
    q = _randn(rng, (b, 1, h, hd), qd, cuda)
    k = _randn(rng, (b, t, kv, hd), cd, cuda)
    v = _randn(rng, (b, t, kv, hd), cd, cuda)
    lengths = {None: rng.integers(1, t + 1, size=b), "one": np.ones(b),
               "full": np.full(b, t)}[edge]
    lengths = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    out = decode_attention(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = decode_attention_plain(q, k, v, lengths, window=window)
    assert out.dtype == qd and out.shape == q.shape
    err = (out.float() - want.float()).abs().max().item()
    assert err <= TOL[qd], err


def _decode_case(rng, b, h, kv, t, hd, qd, cd, lengths, device):
    q = _randn(rng, (b, 1, h, hd), qd, device)
    k = _randn(rng, (b, t, kv, hd), cd, device)
    v = _randn(rng, (b, t, kv, hd), cd, device)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kv,t,hd,window,lengths", [
    # lengths 1, full and between; boundaries of the 16-key tiles
    (3, 8, 2, 256, 32, 0, [1, 256, 77]),
    (2, 8, 2, 300, 128, 0, [17, 300]),
    # windows whose start falls inside a split
    (2, 32, 4, 300, 128, 100, [300, 151]),
    (2, 8, 8, 1000, 64, 300, [1000, 433]),
    # G = 16 over one kv head (MQA); short lengths leave splits empty
    (3, 16, 1, 100, 64, 0, [5, 100, 33]),
    (2, 16, 2, 64, 32, 24, [64, 2]),
    # hd 160: five columns a lane, a one-group combine
    (2, 32, 8, 300, 160, 100, [300, 151]),
    (3, 16, 1, 100, 160, 0, [5, 100, 33]),
])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 64])
@pytest.mark.parametrize("qd,cd", DECODE_DTYPES)
def test_decode_kernel_forced_splits_match_plain_version(
        cuda, b, h, kv, t, hd, window, lengths, splits, qd, cd):
    rng = np.random.default_rng(t + hd + splits)
    q, k, v, lens = _decode_case(rng, b, h, kv, t, hd, qd, cd, lengths, cuda)
    out = torch.empty_like(q)
    decode_kernel.launch(q, k, v, lens, out, split_scratch(q, k, splits),
                         window=window, splits=splits)
    torch.cuda.synchronize()
    want = decode_attention_plain(q, k, v, lens, window=window)
    err = (out.float() - want.float()).abs().max().item()
    assert err <= TOL[qd], err


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [None, 16])
def test_decode_kernel_long_cache_at_batch_one(cuda, splits):
    """B = 1 over a 32k cache (decode_32k's cache at small batch), with
    the wrapper's split count and with 16 splits forced; one length ends
    inside a tile."""
    rng = np.random.default_rng(7)
    for length in (32768, 20001):
        q, k, v, lens = _decode_case(rng, 1, 32, 4, 32768, 128,
                                     torch.bfloat16, torch.float32, [length],
                                     cuda)
        if splits is None:
            out = decode_attention(q, k, v, lens)
        else:
            out = torch.empty_like(q)
            decode_kernel.launch(q, k, v, lens, out,
                                 split_scratch(q, k, splits), window=0,
                                 splits=splits)
        torch.cuda.synchronize()
        want = decode_attention_plain(q, k, v, lens)
        err = (out.float() - want.float()).abs().max().item()
        assert err <= TOL[torch.bfloat16], (length, err)


@pytest.mark.gpu
def test_decode_wrapper_never_synchronises(cuda):
    """A decode step reads lengths only on the card: no host sync, at a
    shape with several splits (split kernel and combine)."""
    rng = np.random.default_rng(8)
    q, k, v, lens = _decode_case(rng, 2, 32, 4, 2048, 128, torch.bfloat16,
                                 torch.float32, [2048, 999], cuda)
    decode_attention(q, k, v, lens)            # build and load first
    torch.cuda.synchronize()
    before = decode_attention.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = decode_attention(q, k, v, lens, window=700)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert decode_attention.launches == before + 1
    want = decode_attention_plain(q, k, v, lens, window=700)
    err = (out.float() - want.float()).abs().max().item()
    assert err <= TOL[torch.bfloat16], err


@pytest.mark.gpu
def test_cuda_tensors_never_fall_back_to_the_plain_version(cuda):
    for hd in (48, 96, 192):                        # hds the kernels lack
        q = torch.zeros(1, 8, 4, hd, device=cuda)
        with pytest.raises(ValueError):
            flash_attention(q, q[:, :, :2], q[:, :, :2])
        with pytest.raises(ValueError):
            decode_attention(q[:, :1], q[:, :, :2], q[:, :, :2],
                             torch.ones(1, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):                 # mixed devices
        flash_attention(torch.zeros(1, 8, 4, 32, device=cuda),
                        torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 2, 32))
    kb = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16, device=cuda)
    qb = torch.zeros(8 * 4 * 32 + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):                 # not 16-byte aligned: TMA
        flash_attention(qb[1:].view(1, 8, 4, 32), kb, kb)
    qd = torch.zeros(2, 1, 4, 32, device=cuda)
    kc = torch.zeros(2, 16, 2, 32, device=cuda)
    with pytest.raises(TypeError):                  # int64 lengths on the card
        decode_attention(qd, kc, kc, torch.ones(2, dtype=torch.int64,
                                                device=cuda))
    with pytest.raises(TypeError):                  # f32 q over a bf16 cache
        decode_attention(qd, kc.bfloat16(), kc.bfloat16(),
                         torch.ones(2, dtype=torch.int32, device=cuda))
