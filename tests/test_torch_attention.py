"""The port's attention wrappers on the CPU (their plain versions) against
the JAX package's oracles and its Pallas kernels in interpret mode.

``repro_torch.kernels.{flash,decode}_attention.ops`` run the plain PyTorch
versions for CPU tensors; here they are held against the reference's
``attention_reference``/``decode_attention_reference`` and against the
Pallas kernels through their ``ops.py`` (interpret mode on the CPU), over
the sweep of ``tests/test_kernels.py`` plus a ragged sequence length, a
non-causal case, mixed bf16-query/f32-cache decode and the edge lengths 1
and T. Tolerances are those of ``tests/test_kernels.py``: 1e-5 in float32
(online softmax and einsum sum in other orders) and 2e-2 in bfloat16 (one
rounding of the output to bfloat16). The CUDA kernels are held against the
same plain versions on the card (``tests/test_torch_attention_gpu.py``).

Decode attention's card decomposition (per-split partials, then their
combine; ``ref.py``) is held against the same oracles, and in float32
within 1e-6 of ``decode_attention_reference`` over split counts that
leave splits empty and windows that start inside a split; the split rule
``ops.num_splits`` is pinned to the shapes alone.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ref import decode_attention_reference
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_reference
from repro_torch.kernels.decode_attention import ref as decode_ref
from repro_torch.kernels.decode_attention.ops import (
    BLOCKS_PER_SM, MIN_SPLIT_KEYS, decode_attention, num_splits,
)
from repro_torch.kernels.flash_attention.ops import flash_attention

TOL = {np.float32: 1e-5, "bfloat16": 2e-2}
DT = {np.float32: (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype):
    """One seeded array as (jax, torch) with identical values."""
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DT[dtype]
    j = jnp.asarray(x, jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# flash attention


FLASH_CASES = [
    # (b, s, h, kv, hd, window, causal, block): tests/test_kernels.py's
    # shapes and windows, then a ragged length and a non-causal case
    (2, 64, 4, 2, 32, 0, True, 32),
    (1, 128, 8, 8, 64, 0, True, 32),
    (2, 64, 4, 1, 32, 0, True, 32),       # MQA
    (1, 256, 4, 2, 128, 0, True, 32),
    (1, 128, 4, 2, 32, 16, True, 32),
    (1, 128, 4, 2, 32, 48, True, 32),
    (1, 128, 4, 2, 32, 100, True, 32),
    (1, 100, 8, 2, 64, 0, True, 20),      # ragged S (not a tile multiple)
    (1, 100, 8, 2, 64, 30, True, 20),
    (2, 64, 4, 2, 32, 0, False, 32),
    # hd 160 (stablelm-12b): causal, windowed, ragged S
    (1, 128, 4, 2, 160, 0, True, 32),
    (1, 128, 4, 2, 160, 48, True, 32),
    (1, 100, 8, 2, 160, 0, True, 20),
]


@pytest.mark.parametrize("b,s,h,kv,hd,window,causal,block", FLASH_CASES)
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_flash_attention_plain_matches_reference_and_pallas(
        b, s, h, kv, hd, window, causal, block, dtype):
    rng = np.random.default_rng(s * 1000 + h * 10 + kv + window)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng, (b, s, n, hd), dtype) for n in (h, kv, kv))
    out = flash_attention(qt, kt, vt, causal=causal, window=window)
    assert out.shape == qt.shape and out.dtype == qt.dtype
    ref = attention_reference(qj.transpose(0, 2, 1, 3), kj.transpose(0, 2, 1, 3),
                              vj.transpose(0, 2, 1, 3), causal=causal,
                              window=window).transpose(0, 2, 1, 3)
    _close(out, ref, TOL[dtype])
    pallas = jax_flash(qj, kj, vj, causal=causal, window=window,
                       block_q=block, block_k=block, interpret=True)
    _close(out, pallas, TOL[dtype])
    assert flash_attention.launches == 0     # CPU tensors never launch


@pytest.mark.parametrize("bad", ["dtype", "shape", "group", "window", "short_t"])
def test_flash_attention_rejects_bad_inputs(bad):
    q, k = torch.zeros(1, 8, 4, 32), torch.zeros(1, 8, 2, 32)
    kw = {}
    if bad == "dtype":
        q = q.double()
    elif bad == "shape":
        k = torch.zeros(1, 8, 2, 16)
    elif bad == "group":
        q = torch.zeros(1, 8, 3, 32)
    elif bad == "window":
        kw["window"] = -1
    else:
        k = torch.zeros(1, 4, 2, 32)
    with pytest.raises((ValueError, TypeError)):
        flash_attention(q, k, k.clone(), **kw)


# ---------------------------------------------------------------------------
# decode attention


DECODE_CASES = [
    # (b, h, kv, t, hd, window, q dtype, cache dtype): tests/test_kernels.py's
    # shapes and windows, bf16, then mixed bf16 q over an f32 cache (the
    # serving path)
    (2, 8, 2, 256, 32, 0, np.float32, np.float32),
    (2, 8, 2, 256, 32, 100, np.float32, np.float32),
    (1, 4, 4, 512, 64, 0, np.float32, np.float32),
    (1, 4, 4, 512, 64, 100, np.float32, np.float32),
    (3, 8, 1, 128, 128, 0, np.float32, np.float32),    # MQA
    (3, 8, 1, 128, 128, 100, np.float32, np.float32),
    (2, 8, 2, 256, 32, 0, "bfloat16", "bfloat16"),
    (4, 32, 4, 64, 128, 0, "bfloat16", np.float32),     # yi-9b heads
    (2, 8, 2, 256, 32, 100, "bfloat16", np.float32),
    # hd 160: stablelm-12b's decode heads (bf16 q over an f32 cache), then
    # f32 over f32 and a window
    (4, 32, 8, 48, 160, 0, "bfloat16", np.float32),
    (2, 8, 2, 256, 160, 0, np.float32, np.float32),
    (2, 8, 2, 256, 160, 100, np.float32, np.float32),
]


def _decode_inputs(b, h, kv, t, hd, qd, cd, lengths):
    rng = np.random.default_rng(b * 100 + t + hd)
    qj, qt = _pair(rng, (b, 1, h, hd), qd)
    (kj, kt), (vj, vt) = (_pair(rng, (b, t, kv, hd), cd) for _ in range(2))
    if lengths is None:
        lengths = rng.integers(1, t, size=b)
    lj = jnp.asarray(lengths, jnp.int32)
    lt = torch.from_numpy(np.asarray(lengths, np.int32))
    return (qj, kj, vj, lj), (qt, kt, vt, lt)


@pytest.mark.parametrize("b,h,kv,t,hd,window,qd,cd", DECODE_CASES)
@pytest.mark.parametrize("edge", [None, "one", "full"])
def test_decode_attention_plain_matches_reference_and_pallas(
        b, h, kv, t, hd, window, qd, cd, edge):
    lengths = {None: None, "one": [1] * b, "full": [t] * b}[edge]
    (qj, kj, vj, lj), (qt, kt, vt, lt) = _decode_inputs(
        b, h, kv, t, hd, qd, cd, lengths)
    out = decode_attention(qt, kt, vt, lt, window=window)
    assert out.shape == qt.shape and out.dtype == qt.dtype
    g = h // kv
    ref = decode_attention_reference(
        qj[:, 0].reshape(b, kv, g, hd), kj.transpose(0, 2, 1, 3),
        vj.transpose(0, 2, 1, 3), lj, window=window).reshape(b, 1, h, hd)
    tol = TOL[qd]
    _close(out, ref, tol)
    pallas = jax_decode(qj, kj, vj, lj, window=window, block_k=64,
                        interpret=True)
    _close(out, pallas, tol)
    assert decode_attention.launches == 0
    # the card's decomposition, split then combined, in the same layout
    q4 = qt[:, 0].reshape(b, kv, g, hd)
    k4, v4 = kt.transpose(1, 2), vt.transpose(1, 2)
    for splits in (1, 3):
        parts = decode_ref.decode_attention_split_partials(
            q4, k4, v4, lt, splits=splits, window=window)
        split = decode_ref.decode_attention_combine(parts, qt.dtype)
        assert split.dtype == qt.dtype
        _close(split.reshape(b, 1, h, hd), ref, tol)
        _close(split.reshape(b, 1, h, hd), pallas, tol)


@pytest.mark.parametrize("bad", ["lengths_dtype", "lengths_shape", "cache_dtype",
                                 "q_len", "group"])
def test_decode_attention_rejects_bad_inputs(bad):
    q, k = torch.zeros(2, 1, 4, 32), torch.zeros(2, 16, 2, 32)
    v, lengths = k.clone(), torch.ones(2, dtype=torch.int32)
    if bad == "lengths_dtype":
        lengths = lengths.float()
    elif bad == "lengths_shape":
        lengths = torch.ones(3, dtype=torch.int32)
    elif bad == "cache_dtype":
        v = v.bfloat16()
    elif bad == "q_len":
        q = torch.zeros(2, 2, 4, 32)
    else:
        q = torch.zeros(2, 1, 3, 32)
    with pytest.raises((ValueError, TypeError)):
        decode_attention(q, k, v, lengths)


# the split-KV decomposition of the card, on the CPU


SPLIT_CASES = [
    # (b, h, kv, t, hd, window, lengths)
    (3, 4, 4, 200, 32, 0, [1, 200, 77]),      # G = 1: lengths 1, T, between
    (2, 32, 2, 300, 64, 100, [300, 150]),     # G = 16, window inside a split
    (2, 16, 1, 64, 32, 0, [64, 5]),           # G = 16 (MQA), empty splits
    (1, 8, 8, 40, 128, 24, [33]),             # G = 1, window
    (2, 32, 8, 300, 160, 100, [300, 151]),    # hd 160, G = 4, window
    (3, 16, 1, 100, 160, 0, [5, 100, 33]),    # hd 160, G = 16, empty splits
]


@pytest.mark.parametrize("b,h,kv,t,hd,window,lengths", SPLIT_CASES)
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 64])
def test_decode_split_then_combine_matches_reference(b, h, kv, t, hd, window,
                                                     lengths, splits):
    rng = np.random.default_rng(t + hd + window)
    g = h // kv
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((b, kv, g, hd), (b, kv, t, hd), (b, kv, t, hd)))
    lens = torch.tensor(lengths, dtype=torch.int32)
    parts = decode_ref.decode_attention_split_partials(
        q, k, v, lens, splits=splits, window=window)
    assert parts.shape == (b, kv, splits, g, hd + 2)
    assert parts.dtype == torch.float32
    out = decode_ref.decode_attention_combine(parts, torch.float32)
    want = decode_ref.decode_attention_reference(q, k, v, lens, window=window)
    assert (out - want).abs().max().item() <= 1e-6
    # an empty split holds the empty state; splits past the live keys'
    # whole tiles are empty
    empty = torch.isneginf(parts[..., hd])
    assert (parts[..., hd + 1][empty] == 0).all()
    assert (parts[..., :hd][empty] == 0).all()
    tile = decode_ref.SPLIT_TILE
    for i, n in enumerate(lengths):
        n -= max(n - window, 0) if window > 0 else 0
        share = -(-(-(-n // splits)) // tile) * tile
        full = -(-n // share)
        assert not empty[i, :, :full].any() and empty[i, :, full:].all()


@pytest.mark.parametrize("t,window,lengths", [
    (200, 0, [1, 200, 77, 16, 17]), (300, 100, [300, 150, 99, 101]),
    (40, 24, [33, 1, 40])])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 64])
def test_decode_split_spans_tile_the_live_range(t, window, lengths, splits):
    """The splits of a sequence cover [lo, len) once, in order, each a
    whole number of tiles but the last non-empty one."""
    tile = decode_ref.SPLIT_TILE
    start, end = decode_ref.split_spans(torch.tensor(lengths), t, splits,
                                        window=window)
    for b, n in enumerate(lengths):
        lo = max(n - window, 0) if window > 0 else 0
        keys = [list(range(s, e)) for s, e in zip(start[b].tolist(),
                                                  end[b].tolist())]
        assert sum(keys, []) == list(range(lo, n))
        sizes = [len(x) for x in keys if x]
        assert all(size % tile == 0 for size in sizes[:-1])
        assert len(sizes) <= splits


def test_num_splits_depends_on_shapes_only():
    assert list(inspect.signature(num_splits).parameters) == [
        "batch", "kv_heads", "cache_len", "sms"]
    assert num_splits(128, 4, 32768, 132) == 1        # decode_32k's batch
    assert num_splits(1, 4, 32768, 132) > 1            # one long sequence
    assert 1 <= num_splits(4, 4, 48, 132) <= 3         # yi-9b's CLI path
    slots = BLOCKS_PER_SM * 132

    def fill(blocks):
        return blocks / (-(-blocks // slots) * slots)

    for b in (1, 2, 4, 32, 64, 96, 128, 1000):
        for kv in (1, 4, 8):
            for t in (1, 16, 48, 1000, 32768):
                s = num_splits(b, kv, t, 132)
                assert s >= 1 and s == num_splits(b, kv, t, 132)
                assert s == 1 or s <= t // MIN_SPLIT_KEYS
                assert b * kv * s < 2 * slots + b * kv   # two waves at most
                assert fill(b * kv * s) >= fill(b * kv) - 0.01
