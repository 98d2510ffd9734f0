"""Mamba2 (SSD) mixer block — arXiv:2405.21060; the port's twin of the JAX
package's ``models/mamba2.py``.

Layer = RMSNorm -> in_proj -> causal depthwise conv (x, B, C channels) ->
SSD scan -> gated RMSNorm -> out_proj, residual. Prefill runs the chunked
dual form through ``kernels/ssd_scan`` (the hand-written kernel on the
card); decode runs the O(1) recurrence ``ssd_decode_step`` as torch code,
with a (conv, ssm) state cache updated in place.

The reference passes ``cfg.ssd_intra_dtype`` to its jnp scan, which with
``"bfloat16"`` rounds the decay, the scores and x before the intra-chunk
product. The Pallas kernel ignores the setting and keeps all of it in
float32; the port follows the kernel's contract (ROADMAP C4).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_decode_step
from repro_torch.models.layers import rmsnorm, rmsnorm_spec
from repro_torch.nn.module import ParamSpec

NGROUPS = 1  # B/C projection groups (GQA-analogue); 1 per Mamba2 defaults


def mamba_dims(cfg: ModelConfig) -> dict:
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_headdim
    conv_channels = d_inner + 2 * NGROUPS * cfg.ssm_state
    return {
        "d_inner": d_inner,
        "nheads": nheads,
        "conv_channels": conv_channels,
        "in_proj": 2 * d_inner + 2 * NGROUPS * cfg.ssm_state + nheads,
    }


def mamba_specs(cfg: ModelConfig, stack: Tuple[int, ...] = ()) -> dict:
    dims = mamba_dims(cfg)
    d = cfg.d_model
    return {
        "in_proj": ParamSpec(stack + (d, dims["in_proj"]), init="fan_in"),
        "conv_w": ParamSpec(stack + (cfg.ssm_conv, dims["conv_channels"]),
                            init="fan_in"),
        "conv_b": ParamSpec(stack + (dims["conv_channels"],), init="zeros"),
        "a_log": ParamSpec(stack + (dims["nheads"],), init="zeros"),
        "d_skip": ParamSpec(stack + (dims["nheads"],), init="ones"),
        "dt_bias": ParamSpec(stack + (dims["nheads"],), init="zeros"),
        "gate_norm": ParamSpec(stack + (dims["d_inner"],), init="ones"),
        "out_proj": ParamSpec(stack + (dims["d_inner"], d), init="fan_in"),
        "norm": rmsnorm_spec(d, stack),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, ...]:
    dims = mamba_dims(cfg)
    di, gn = dims["d_inner"], NGROUPS * cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * gn]
    dt = zxbcdt[..., 2 * di + 2 * gn:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence dim. xbc: (B, L, C), w:
    (W, C). Accumulates in float32, then SiLU, then the input's dtype."""
    width, length = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(width):
        out = out + pad[:, i:i + length, :].float() * w[i].float()
    return F.silu(out + b.float()).to(xbc.dtype)


def _decode_recurrence(xbc, dt, a, d_skip, conv_w, conv_b, cache, cfg,
                       dtype) -> torch.Tensor:
    """One decode token's conv and SSM recurrence: rolls the conv window and
    writes the new state into ``cache`` in place; returns y (B, 1, H, P)
    in float32. ``conv_w`` (W, C) or (B, W, C), ``conv_b``, ``a`` and
    ``d_skip`` of one model or with a leading request axis: both
    broadcast."""
    dims = mamba_dims(cfg)
    bsz, gn = xbc.shape[0], NGROUPS * cfg.ssm_state
    conv_state = cache["conv"]                           # (B, W-1, C)
    window = torch.cat([conv_state, xbc.to(conv_state.dtype)], dim=1)
    conv_out = (window.float() * conv_w.float()).sum(dim=1)
    xbc_t = F.silu(conv_out + conv_b.float()).to(dtype)
    conv_state.copy_(window[:, 1:, :])                   # drop the oldest column
    x_t = xbc_t[..., :dims["d_inner"]].reshape(
        bsz, dims["nheads"], cfg.ssm_headdim)
    bc = xbc_t[..., dims["d_inner"]:]
    b_t = bc[..., :gn].reshape(bsz, NGROUPS, cfg.ssm_state)
    c_t = bc[..., gn:].reshape(bsz, NGROUPS, cfg.ssm_state)
    y_t, new_ssm = ssd_decode_step(cache["ssm"], x_t, dt[:, 0, :], a, b_t, c_t)
    cache["ssm"].copy_(new_ssm)
    return y_t[:, None] + d_skip * x_t[:, None].float()


def mamba_block(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Pre-norm Mamba2 residual block. ``cache=None`` -> full-sequence SSD
    scan; ``cache={"conv": (B, W-1, C), "ssm": (B, H, N, P)}`` -> one-token
    decode, writing the rolled conv window and the new state into the
    cache tensors in place. Returns (x + out, cache)."""
    dims = mamba_dims(cfg)
    bsz, l, _ = x.shape
    gn = NGROUPS * cfg.ssm_state
    h = rmsnorm(x, params["norm"], cfg.norm_eps)
    zxbcdt = h @ params["in_proj"].to(h.dtype)
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    a = -torch.exp(params["a_log"].float())
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    d_skip = params["d_skip"].float()[None, None, :, None]

    if cache is None:
        xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
        # views of the conv output: the kernel reads them through strides
        x_heads = xbc[..., :dims["d_inner"]].reshape(
            bsz, l, dims["nheads"], cfg.ssm_headdim)
        bc = xbc[..., dims["d_inner"]:]
        b_mat = bc[..., :gn].reshape(bsz, l, NGROUPS, cfg.ssm_state)
        c_mat = bc[..., gn:].reshape(bsz, l, NGROUPS, cfg.ssm_state)
        y = ssd_scan(x_heads, dt, a, b_mat, c_mat, chunk=cfg.ssm_chunk)
        y = y + d_skip * x_heads.float()
    else:
        y = _decode_recurrence(xbc, dt, a, d_skip, params["conv_w"],
                               params["conv_b"], cache, cfg, x.dtype)
    y = y.reshape(bsz, l, dims["d_inner"]).to(x.dtype)
    gated = y * F.silu(z.float()).to(x.dtype)
    gated = rmsnorm(gated, params["gate_norm"], cfg.norm_eps)
    out = gated @ params["out_proj"].to(x.dtype)
    return x + out, cache


def mamba_block_lanes(params, x: torch.Tensor, cfg: ModelConfig, *,
                      cache: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, dict]:
    """``mamba_block``'s one-token decode with every leaf carrying a leading
    request axis B (request b's own model in row b): ``in_proj`` and
    ``out_proj`` are batched matrix products, ``conv_w`` (B, W, C),
    ``conv_b`` (B, C), ``a_log``, ``dt_bias`` and ``d_skip`` (B, H). Each
    request's cache row is its own."""
    dims = mamba_dims(cfg)
    bsz, l, _ = x.shape
    h = rmsnorm(x, params["norm"][:, None], cfg.norm_eps)
    zxbcdt = h @ params["in_proj"].to(h.dtype)
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    a = -torch.exp(params["a_log"].float())
    dt = F.softplus(dt.float() + params["dt_bias"].float()[:, None])
    d_skip = params["d_skip"].float()[:, None, :, None]
    y = _decode_recurrence(xbc, dt, a, d_skip, params["conv_w"],
                           params["conv_b"], cache, cfg, x.dtype)
    y = y.reshape(bsz, l, dims["d_inner"]).to(x.dtype)
    gated = y * F.silu(z.float()).to(x.dtype)
    gated = rmsnorm(gated, params["gate_norm"][:, None], cfg.norm_eps)
    out = gated @ params["out_proj"].to(x.dtype)
    return x + out, cache


def mamba_cache_shape(cfg: ModelConfig, batch: int) -> Dict[str, torch.Tensor]:
    """The decode cache of one layer as float32 meta tensors (no
    allocation): the conv window (B, W-1, C) and the SSM state
    (B, H, N, P)."""
    dims = mamba_dims(cfg)
    f32 = torch.float32
    return {
        "conv": torch.empty((batch, cfg.ssm_conv - 1, dims["conv_channels"]),
                            dtype=f32, device="meta"),
        "ssm": torch.empty((batch, dims["nheads"], cfg.ssm_state,
                            cfg.ssm_headdim), dtype=f32, device="meta"),
    }
