"""The flash attention's training route on the CPU against the JAX
package: the gradient of the port's attention (autograd through the plain
version, which is what ``flash_attention`` runs on a CPU tensor), the
backward wrapper's plain version ``flash_attention_bwd_plain``, each
against ``jax.grad`` of the reference's
``kernels/flash_attention/ref.py::attention_reference``; and the plain
``lse`` against a float64 numpy log-sum-exp.

Inputs are drawn with numpy from a seed and cross as numpy arrays. Cases
cover GQA (G = 1, 2, 4), MQA, windows that start inside a 32-key tile
and ragged S (not a multiple of the kernels' 32-row float32 tiles), and
hd 160.

Tolerance: float32 on both sides, summed in other orders: every gradient
within ``GRAD_TOL`` = 1e-5 of the reference's, relative to the largest
|gradient| of that tensor (measured up to 5.3e-7). bfloat16 inputs: the
plain version computes in float32 and rounds each gradient once, so it is
held at ``BF16_TOL`` = 2**-7 relative (one bfloat16 rounding is at most
2**-8; measured up to 3.2e-3).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import torch_parity  # noqa: F401  (one torch thread in each test worker)

from repro.kernels.flash_attention.ref import (
    attention_reference as jax_attention,
)
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ops import (
    flash_attention, flash_attention_bwd,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_lse_plain, flash_attention_bwd_plain,
)

GRAD_TOL = 1e-5
BF16_TOL = 2.0 ** -7
T = (0, 2, 1, 3)            # (B, S, H, hd) <-> (B, H, S, hd)

CASES = [  # b, s, h, kv, hd, causal, window
    (2, 16, 2, 2, 32, True, 0),
    (1, 100, 4, 2, 32, True, 0),        # ragged S, G = 2
    (1, 70, 4, 1, 64, True, 0),         # MQA
    (2, 33, 4, 4, 32, False, 0),        # no mask
    (1, 100, 4, 2, 32, True, 17),       # a window inside a tile
    (1, 90, 8, 2, 32, True, 70),        # G = 4, window across tiles
    (1, 40, 2, 1, 160, True, 5),        # hd 160
    (1, 48, 2, 2, 32, False, 9),        # a window without causality
]


def _inputs(b, s, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    do = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    return q, k, v, do


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _jax_grad_fn(q, k, v, do, causal, window):
    def f(q, k, v):
        out = jax_attention(q.transpose(T), k.transpose(T), v.transpose(T),
                            causal=causal, window=window).transpose(T)
        return jnp.sum(out * do)
    return jax.grad(f, argnums=(0, 1, 2))(q, k, v)


def _jax_grads(q, k, v, do, causal, window):
    """jax.grad of <attention(q, k, v), do> in the model's layout."""
    return [np.asarray(g) for g in _jax_grad_fn(
        *(jnp.asarray(x) for x in (q, k, v, do)), causal=causal,
        window=window)]


@functools.cache
def _case(b, s, h, kv, hd, causal, window):
    """A case's inputs and the reference's gradients, made once."""
    inputs = _inputs(b, s, h, kv, hd)
    return inputs, _jax_grads(*inputs, causal, window)


def _assert_close(got, want, tol):
    for g, w in zip(got, want):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g - w).max() <= tol * scale, (np.abs(g - w).max(),
                                                     scale)


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", CASES)
def test_autograd_through_the_port_matches_jax_grad(b, s, h, kv, hd, causal,
                                                    window):
    (q, k, v, do), want = _case(b, s, h, kv, hd, causal, window)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    before = flash_attention.launches
    out = flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert flash_attention.launches == before      # the CPU launches none
    _assert_close(got, want, GRAD_TOL)


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", CASES)
def test_backward_wrapper_and_plain_lse_match_the_reference(
        b, s, h, kv, hd, causal, window):
    (q, k, v, do), want = _case(b, s, h, kv, hd, causal, window)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    lse = attention_lse_plain(tq, tk, causal=causal, window=window)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(tq, tk, tv, tdo, lse, causal=causal,
                              window=window)
    assert flash_attention_bwd.launches == before
    _assert_close(got, want, GRAD_TOL)
    _assert_close(flash_attention_bwd_plain(tq, tk, tv, tdo, causal=causal,
                                            window=window), want, GRAD_TOL)
    # lse: each row's log-sum-exp of its visible scaled scores, (B, H, S),
    # against float64 numpy
    qh = q.astype(np.float64).transpose(T).reshape(b, kv, h // kv, s, hd)
    sc = np.einsum("bkgsd,bktd->bkgst", qh,
                   k.astype(np.float64).transpose(T)) / hd ** 0.5
    rows, cols = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = np.ones((s, s), bool)
    if causal:
        mask &= rows >= cols
    if window > 0:
        mask &= rows - cols < window
    sc = np.where(mask, sc, -np.inf)
    top = sc.max(-1, keepdims=True)
    want_lse = (top[..., 0] + np.log(np.exp(sc - top).sum(-1))).reshape(
        b, h, s)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window", CASES[:3])
def test_bfloat16_plain_backward_rounds_once(b, s, h, kv, hd, causal,
                                             window):
    q, k, v, do = _inputs(b, s, h, kv, hd, seed=2)
    bf = [torch.from_numpy(x).bfloat16() for x in (q, k, v, do)]
    # the reference on the bf16 values, computed in float32
    want = _jax_grads(*(x.float().numpy() for x in bf), causal, window)
    got = flash_attention_bwd_plain(*bf, causal=causal, window=window)
    assert all(g.dtype == torch.bfloat16 for g in got)
    _assert_close(got, want, BF16_TOL)
    exact = flash_attention_bwd_plain(*bf, causal=causal, window=window,
                                      dtype=torch.float64)
    _assert_close(got, [e.double().numpy() for e in exact], BF16_TOL)


def test_backward_rejects_what_the_kernel_does_not_take():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 1, 32))
    lse = attention_lse_plain(q, k)
    with pytest.raises(ValueError, match="T == S"):
        flash_attention_bwd(q, torch.cat([k, k], 1), torch.cat([v, v], 1),
                            do, lse, causal=False)
    with pytest.raises(ValueError, match="lse must be"):
        flash_attention_bwd(q, k, v, do, lse[:, :1])
    with pytest.raises(ValueError, match="dout must be"):
        flash_attention_bwd(q, k, v, do[:, :8], lse)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ops._check_cuda("flash_attention_bwd", q=q.to("meta"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_take_only_16_byte_aligned_operands(dtype):
    """Both kernels' routes read their operands 16 bytes at a time (TMA in
    bfloat16, cp.async in float32): the wrappers' check passes a fresh
    tensor and refuses a contiguous view one element into its storage."""
    q = torch.zeros(1, 8, 2, 32, dtype=dtype)
    ops._check_aligned(q=q, k=q[:, :, :1].contiguous())
    shifted = torch.zeros(q.numel() + 1, dtype=dtype)[1:].view(q.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="dout must be 16-byte aligned"):
        ops._check_aligned(q=q, dout=shifted)
