"""Plain PyTorch version of the Mamba2 SSD (state-space duality) chunked
scan and its one-token recurrence — the twins of the JAX package's
``kernels/ssd_scan/ref.py::ssd_reference`` and ``ssd_decode_step``.

For each head independently,

    y_i = sum_{j <= i} C_i^T ( prod_{j < r <= i} exp(dt_r A) ) B_j x_j dt_j

i.e. the linear recurrence ``S_i = exp(dt_i A) S_{i-1} + dt_i B_i x_i^T``,
``y_i = C_i^T S_i``, evaluated in the chunked dual form of
arXiv:2405.21060. ``ssd_reference`` is what ``csrc/ssd_scan.cu`` computes
(with ``intra_dtype=float32``, the kernels' contract), as three passes
that the kernel's three passes match one for one: chunk states, state
passing, chunk outputs. The CPU runs it in place of the kernel, and on the
card the kernel, and each of its passes, is held against it.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def ssd_chunk_states(
    x: torch.Tensor,       # (B, L, H, P), L a multiple of the chunk
    dt: torch.Tensor,      # (B, L, H)
    a: torch.Tensor,       # (H,)
    b_mat: torch.Tensor,   # (B, L, G, N)
    chunk: int = 128,
):
    """Pass A of the three-pass form: each chunk's own contribution to the
    state, ``states`` (B, NC, H, N, P) = sum_j exp(cs_Q - cs_j) dt_j B_j
    x_j^T, and its decay ``chunk_decay`` (B, NC, H) = exp(cs_Q), both
    float32."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    nc, q = l // chunk, chunk
    rep = h // g

    f32 = torch.float32
    x_ = x.reshape(bsz, nc, q, h, p).to(f32)
    dt_ = dt.reshape(bsz, nc, q, h).to(f32)
    b_ = b_mat.reshape(bsz, nc, q, g, n).to(f32)

    da = dt_ * a.to(f32)                           # (b,nc,q,h), negative
    cs = torch.cumsum(da, dim=2)                   # within-chunk cumulative decay

    # chunk summary states: sum_j exp(cs_last - cs_j) dt_j B_j x_j^T
    last = cs[:, :, -1:, :]                                    # (b,nc,1,h)
    w = torch.exp(last - cs) * dt_                             # (b,nc,q,h)
    b_exp = torch.repeat_interleave(b_, rep, dim=3)            # (b,nc,q,h,n)
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", w, b_exp, x_)
    chunk_decay = torch.exp(cs[:, :, -1, :])                   # (b,nc,h)
    return states, chunk_decay


def ssd_state_passing(states: torch.Tensor,
                      chunk_decay: torch.Tensor) -> torch.Tensor:
    """Pass B: the inter-chunk recurrence S_c = exp(sum da_c) S_{c-1} +
    states_c from a zero state, in chunk order. Returns the state from
    before each chunk, (B, NC, H, N, P)."""
    bsz, nc, h, n, p = states.shape
    s = torch.zeros((bsz, h, n, p), dtype=torch.float32,
                    device=states.device)
    before = []
    for c in range(nc):
        before.append(s)
        s = chunk_decay[:, c, :, None, None] * s + states[:, c]
    return torch.stack(before, dim=1)                          # (b,nc,h,n,p)


def ssd_chunk_outputs(
    x: torch.Tensor,        # (B, L, H, P), L a multiple of the chunk
    dt: torch.Tensor,       # (B, L, H)
    a: torch.Tensor,        # (H,)
    b_mat: torch.Tensor,    # (B, L, G, N)
    c_mat: torch.Tensor,    # (B, L, G, N)
    s_before: torch.Tensor,  # (B, NC, H, N, P) from ssd_state_passing
    chunk: int = 128,
    intra_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Pass C: y (B, L, H, P) in x's dtype, the intra-chunk (dual
    quadratic) form plus exp(cs_i) C_i . S_before of each chunk.
    ``intra_dtype`` as in ``ssd_reference``."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    nc, q = l // chunk, chunk
    rep = h // g

    f32 = torch.float32
    x_ = x.reshape(bsz, nc, q, h, p).to(f32)
    dt_ = dt.reshape(bsz, nc, q, h).to(f32)
    b_ = b_mat.reshape(bsz, nc, q, g, n).to(f32)
    c_ = c_mat.reshape(bsz, nc, q, g, n).to(f32)

    da = dt_ * a.to(f32)                           # (b,nc,q,h), negative
    cs = torch.cumsum(da, dim=2)                   # within-chunk cumulative decay

    # intra-chunk (dual quadratic form): decay(i,j) = exp(cs_i - cs_j), i >= j
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]          # (b,nc,qi,qj,h)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    seg = torch.where(mask[None, None, :, :, None], seg,
                      torch.tensor(NEG_INF, dtype=f32, device=x.device))
    decay = torch.exp(seg).to(intra_dtype)

    cb = torch.einsum("bcign,bcjgn->bcijg", c_, b_).to(intra_dtype)
    cb = torch.repeat_interleave(cb, rep, dim=-1)              # (b,nc,qi,qj,h)
    att = cb * decay * dt_[:, :, None, :, :].to(intra_dtype)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att,
                           x_.to(intra_dtype)).to(f32)

    # inter-chunk contribution y_i += exp(cs_i) C_i . S_before
    c_exp = torch.repeat_interleave(c_, rep, dim=3)            # (b,nc,q,h,n)
    y_inter = torch.einsum("bcqh,bcqhn,bchnp->bcqhp", torch.exp(cs), c_exp,
                           s_before)

    y = (y_intra + y_inter).reshape(bsz, l, h, p)
    return y.to(x.dtype)


def pad_to_chunks(x, dt, b_mat, c_mat, chunk):
    """x, dt, B and C with a ragged tail padded to a whole chunk with zeros
    (dt = 0: identity decay, no input), as the reference pads."""
    pad = -x.shape[1] % chunk
    if pad == 0:
        return x, dt, b_mat, c_mat
    F = torch.nn.functional
    return (F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
            F.pad(b_mat, (0, 0, 0, 0, 0, pad)),
            F.pad(c_mat, (0, 0, 0, 0, 0, pad)))


def ssd_reference(
    x: torch.Tensor,       # (B, L, H, P)  inputs per head
    dt: torch.Tensor,      # (B, L, H)     positive step sizes
    a: torch.Tensor,       # (H,)          negative decay rates (A = -exp(A_log))
    b_mat: torch.Tensor,   # (B, L, G, N)  input projections (G groups)
    c_mat: torch.Tensor,   # (B, L, G, N)  output projections
    chunk: int = 128,
    intra_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Returns y (B, L, H, P) in x's dtype. A ragged tail is padded to a
    whole chunk with dt = 0 (identity decay, no input), as the reference
    does. ``intra_dtype`` rounds the decay, the C·Bᵀ scores, dt and x
    before the intra-chunk product, as the reference's argument of that
    name does; everything else runs in float32. The three passes
    ``ssd_chunk_states``, ``ssd_state_passing`` and ``ssd_chunk_outputs``
    compose it, as the kernel's three passes do."""
    l = x.shape[1]
    x, dt, b_mat, c_mat = pad_to_chunks(x, dt, b_mat, c_mat, chunk)
    states, chunk_decay = ssd_chunk_states(x, dt, a, b_mat, chunk)
    s_before = ssd_state_passing(states, chunk_decay)
    y = ssd_chunk_outputs(x, dt, a, b_mat, c_mat, s_before, chunk,
                          intra_dtype)
    return y[:, :l]


def ssd_decode_step(
    state: torch.Tensor,   # (B, H, N, P) running SSM state
    x_t: torch.Tensor,     # (B, H, P)
    dt_t: torch.Tensor,    # (B, H)
    a: torch.Tensor,       # (H,)
    b_t: torch.Tensor,     # (B, G, N)
    c_t: torch.Tensor,     # (B, G, N)
):
    """Single-token recurrence of the decode step. Returns (y_t in x_t's
    dtype, new_state in state's dtype); the arithmetic runs in float32.
    Broadcast products and one matmul in place of the reference's einsums:
    the decode step runs this once a layer, and a three-operand einsum
    costs far more host time than the arithmetic it does."""
    h = x_t.shape[1]
    g = b_t.shape[1]
    rep = h // g
    f32 = torch.float32
    dt_t = dt_t.to(f32)
    decay = torch.exp(dt_t * a.to(f32))                        # (B,H)
    b_exp = torch.repeat_interleave(b_t.to(f32), rep, dim=1)   # (B,H,N)
    c_exp = torch.repeat_interleave(c_t.to(f32), rep, dim=1)
    outer = (dt_t[:, :, None] * b_exp)[..., None] * x_t.to(f32)[:, :, None, :]
    new_state = decay[:, :, None, None] * state.to(f32) + outer
    y = torch.matmul(c_exp[:, :, None, :], new_state)[:, :, 0]
    return y.to(x_t.dtype), new_state.to(state.dtype)
