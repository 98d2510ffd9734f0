"""Shared transformer primitives — the port's twin of the JAX package's
``models/layers.py``: RMSNorm, RoPE, GQA attention (prefill and
decode-with-cache), SwiGLU FFN, embeddings.

Functions are pure apart from the KV cache, which ``attention_block``
updates in place (the reference returns a new cache; in place saves a copy
of the whole cache per token). Parameters come in as nested dicts built
from ``ParamSpec`` trees, one layer's slice of the stack at a time, with
the reference's names and layouts. Weights are float32 and cast to the
activation dtype where they are used, as in the reference.

Attention goes through the port's kernels: ``flash_attention`` without a
cache and ``decode_attention`` with one. The reference's jnp attention
rounds the softmax probabilities to the activation dtype before the PV
product; the kernels' contract keeps them in float32, so in bfloat16 the
two differ by that rounding (ROADMAP C3).

The ``*_lanes`` functions are the decode path of a model fleet
(``serve/fleet.py``): every parameter leaf carries a leading request axis
B, request b's own model in row b, so the projections are batched matrix
products.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.nn.module import ParamSpec

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def activation_dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype {cfg.dtype!r} is not one of {sorted(_DTYPES)}")
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# norm


def rmsnorm_spec(d: int, stack: Tuple[int, ...] = ()) -> ParamSpec:
    return ParamSpec(stack + (d,), init="ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dtype)


# ---------------------------------------------------------------------------
# rotary embeddings


def rope_frequencies(head_dim: int, theta: float,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., S, hd/2)
    sin = torch.sin(angles)[..., None, :]                      # (..., S, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention


def attention_specs(cfg: ModelConfig, stack: Tuple[int, ...] = ()) -> dict:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    return {
        "wq": ParamSpec(stack + (d, h, hd), init="fan_in"),
        "wk": ParamSpec(stack + (d, kv, hd), init="fan_in"),
        "wv": ParamSpec(stack + (d, kv, hd), init="fan_in"),
        "wo": ParamSpec(stack + (h, hd, d), init="fan_in"),
        "norm": rmsnorm_spec(d, stack),
    }


def _project(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,d...->bs...", h, w) as one matrix product."""
    out = h @ w.to(h.dtype).reshape(w.shape[0], -1)
    return out.view(*h.shape[:-1], *w.shape[1:])


def _attend_cached(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cache: dict, cfg: ModelConfig,
                   decode_pos: Optional[int]) -> torch.Tensor:
    """Write the new token's k and v into the cache in place and attend q
    over it with ``decode_attention`` (looked up in this module when
    called, so a comparison harness can swap it)."""
    if decode_pos is None:
        raise ValueError("decoding with a cache needs decode_pos")
    width = cache["k"].shape[1]
    if cfg.rolling_cache and cfg.sliding_window > 0:
        # ring buffer of window size: softmax is permutation-invariant
        # and keys carry absolute RoPE phases, so slot order is irrelevant
        insert_at = decode_pos % width
        attend_pos = min(decode_pos, width - 1)
        window = 0                     # the whole buffer is the window
    else:
        if not 0 <= decode_pos < width:
            raise ValueError(f"decode_pos {decode_pos} is outside the "
                             f"cache of {width} positions")
        insert_at = attend_pos = decode_pos
        window = cfg.sliding_window
    s = k.shape[1]
    cache["k"][:, insert_at:insert_at + s] = k.to(cache["k"].dtype)
    cache["v"][:, insert_at:insert_at + s] = v.to(cache["v"].dtype)
    lengths = torch.full((q.shape[0],), attend_pos + 1, dtype=torch.int32,
                         device=q.device)
    return decode_attention(q, cache["k"], cache["v"], lengths, window=window)


def attention_block(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: Optional[dict] = None,
    decode_pos: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Pre-norm attention residual block. Returns (x + attn, cache): without
    a cache the whole sequence goes through ``flash_attention`` (with
    ``attn_block > 0`` too — the reference's blockwise path computes the
    same function); with one, the new token is written into the cache in
    place and ``decode_attention`` reads it back."""
    h = rmsnorm(x, params["norm"], cfg.norm_eps)
    q = apply_rope(_project(h, params["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project(h, params["wk"]), positions, cfg.rope_theta)
    v = _project(h, params["wv"])

    if cache is None:
        attn = flash_attention(q, k, v, causal=True,
                               window=cfg.sliding_window)
    else:
        attn = _attend_cached(q, k, v, cache, cfg, decode_pos)
    b, s = attn.shape[:2]
    out = attn.reshape(b, s, -1) @ params["wo"].to(attn.dtype).reshape(
        -1, params["wo"].shape[-1])
    return x + out, cache


def _project_lanes(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``_project`` with a request axis: h (B, S, d), w (B, d, ...), one
    batched matrix product."""
    out = h @ w.to(h.dtype).reshape(w.shape[0], w.shape[1], -1)
    return out.view(*h.shape[:-1], *w.shape[2:])


def attention_block_lanes(params, x: torch.Tensor, cfg: ModelConfig, *,
                          positions: torch.Tensor, cache: dict,
                          decode_pos: int) -> Tuple[torch.Tensor, dict]:
    """``attention_block``'s decode with every leaf carrying a leading
    request axis B (request b's own model in row b): the projections are
    batched matrix products, and each request's cache row is its own, so
    ``decode_attention`` runs at batch B as for one model."""
    h = rmsnorm(x, params["norm"][:, None], cfg.norm_eps)
    q = apply_rope(_project_lanes(h, params["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_project_lanes(h, params["wk"]), positions, cfg.rope_theta)
    v = _project_lanes(h, params["wv"])
    attn = _attend_cached(q, k, v, cache, cfg, decode_pos)
    b, s = attn.shape[:2]
    wo = params["wo"]
    out = attn.reshape(b, s, -1) @ wo.to(attn.dtype).reshape(
        b, -1, wo.shape[-1])
    return x + out, cache


# ---------------------------------------------------------------------------
# dense (SwiGLU) FFN


def ffn_specs(cfg: ModelConfig, stack: Tuple[int, ...] = ()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec(stack + (d, f), init="fan_in"),
        "w_up": ParamSpec(stack + (d, f), init="fan_in"),
        "w_down": ParamSpec(stack + (f, d), init="fan_in"),
        "norm": rmsnorm_spec(d, stack),
    }


def ffn_block(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(x, params["norm"], cfg.norm_eps)
    gate = h @ params["w_gate"].to(h.dtype)
    up = h @ params["w_up"].to(h.dtype)
    return x + (F.silu(gate) * up) @ params["w_down"].to(h.dtype)


def ffn_block_lanes(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``ffn_block`` with a leading request axis on every leaf: the (B, d, f)
    weights are batched matrix products as written; the norm broadcasts
    over (B, 1, d)."""
    h = rmsnorm(x, params["norm"][:, None], cfg.norm_eps)
    gate = h @ params["w_gate"].to(h.dtype)
    up = h @ params["w_up"].to(h.dtype)
    return x + (F.silu(gate) * up) @ params["w_down"].to(h.dtype)


# ---------------------------------------------------------------------------
# embeddings / head


def embedding_specs(cfg: ModelConfig) -> dict:
    specs = {"final_norm": rmsnorm_spec(cfg.d_model)}
    if cfg.input_mode == "tokens":
        specs["embed"] = ParamSpec((cfg.vocab_size, cfg.d_model), init="embed")
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                     init="fan_in")
    return specs


def embed_tokens(params: dict, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    # The reference casts the table, then gathers: its backward scatter-adds
    # the rows' cotangents in the activation dtype and rounds to the
    # parameter dtype once. Training does the same (ROADMAP C13); without a
    # gradient the rows are gathered first (the same values), so serving
    # never casts the vocab x d table. ``.to`` is a no-op when the dtypes
    # agree.
    table = params["embed"]
    if torch.is_grad_enabled() and table.requires_grad:
        return table.to(activation_dtype(cfg))[tokens]
    return table[tokens].to(activation_dtype(cfg))


def unembed(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x @ w.to(x.dtype)


def embed_tokens_lanes(embed: torch.Tensor, lanes: torch.Tensor,
                       tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Request b's tokens (B, S) looked up in its own model's table: the
    ``(K, V, d)`` fleet tables are indexed at ``[lanes[b], token]``, never
    gathered whole."""
    return embed[lanes[:, None], tokens.long()].to(activation_dtype(cfg))


def unembed_lanes(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``unembed`` with a leading request axis on every leaf."""
    x = rmsnorm(x, params["final_norm"][:, None], cfg.norm_eps)
    w = (params["embed"].transpose(-1, -2) if cfg.tie_embeddings
         else params["unembed"])
    return x @ w.to(x.dtype)
