"""Decoder model of the LM zoo — the port's twin of the JAX package's
``models/transformer.py``, for the ``dense`` and ``ssm`` families.

A model is a repetition of a *block pattern*, the smallest repeating
sequence of (mixer, ffn) layer kinds: a dense decoder's is
``[("attn", "dense")]``, a Mamba2 model's ``[("ssm", "none")]``.
Parameters for each pattern position are stacked over a leading
``num_repeats`` dim with the reference's names
(``blocks/pos0/attn/{wq,wk,wv,wo,norm}``, ``blocks/pos0/ffn/...``,
``blocks/pos0/ssm/{in_proj,conv_w,...}``,
``embed/{embed,unembed,final_norm}``), so a numpy tree of the reference's
weights loads one-to-one (``lm_params_from_numpy``). The reference applies
the stack with ``lax.scan``; here a Python loop walks it, one layer's
slice at a time. The decode cache (KV for attention, conv window and SSM
state for Mamba2) is updated in place. The other families (moe, hybrid,
vlm, audio) raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.mamba2 import (
    mamba_block, mamba_cache_shape, mamba_specs,
)
from repro_torch.nn.module import init_params

Params = Dict[str, Any]          # nested dict of tensors

_NOT_PORTED = {"moe": "A10", "hybrid": "A10", "vlm": "A10", "audio": "A10"}


# ---------------------------------------------------------------------------
# pattern


def block_pattern(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """Returns [(mixer_kind, ffn_kind)] of length = pattern period."""
    if cfg.family not in ("dense", "ssm"):
        item = _NOT_PORTED.get(cfg.family)
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet"
            + (f" (ROADMAP {item})" if item else ""))
    if cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"input_mode {cfg.input_mode!r} is not ported yet (ROADMAP A10)")
    if cfg.family == "ssm":
        return [("ssm", "none")]
    period = cfg.attn_every if cfg.attn_every > 0 else 1
    pattern = []
    for pos in range(period):
        if cfg.moe_on_layer(pos):
            raise NotImplementedError("MoE layers are not ported yet "
                                      "(ROADMAP A10)")
        pattern.append(("attn", "dense" if cfg.d_ff > 0 else "none"))
    return pattern


def num_repeats(cfg: ModelConfig) -> int:
    period = len(block_pattern(cfg))
    if cfg.num_layers % period != 0:
        raise ValueError(f"num_layers={cfg.num_layers} is not a multiple of "
                         f"the pattern period {period}")
    return cfg.num_layers // period


# ---------------------------------------------------------------------------
# specs and weights


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    reps = (num_repeats(cfg),)
    blocks = {}
    for pos, (mixer, ffn) in enumerate(block_pattern(cfg)):
        entry: Dict[str, Any] = {}
        if mixer == "attn":
            entry["attn"] = L.attention_specs(cfg, stack=reps)
        elif mixer == "ssm":
            entry["ssm"] = mamba_specs(cfg, stack=reps)
        if ffn == "dense":
            entry["ffn"] = L.ffn_specs(cfg, stack=reps)
        blocks[f"pos{pos}"] = entry
    return {"embed": L.embedding_specs(cfg), "blocks": blocks}


def init_model(gen: torch.Generator, cfg: ModelConfig,
               device: torch.device) -> Params:
    return init_params(gen, model_specs(cfg), device)


def lm_params_from_numpy(tree: Mapping[str, Any],
                         device: torch.device) -> Params:
    """The JAX package's nested LM parameter tree (as numpy arrays, e.g.
    ``jax.device_get(params)``) as the port's float32 tensors on ``device``
    — same nesting, names and layout."""
    return {k: (lm_params_from_numpy(v, device) if isinstance(v, Mapping)
                else torch.from_numpy(np.array(v, np.float32)).to(device))
            for k, v in sorted(tree.items())}


def _layer(tree: Mapping[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s slice of a stacked tree (views: writes go through)."""
    return {k: (_layer(v, i) if isinstance(v, Mapping) else v[i])
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# forward (prefill)


def _apply_block_position(
    entry: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    cache_entry: Optional[dict],
    decode_pos: Optional[int],
) -> torch.Tensor:
    """One (mixer, ffn) position of one layer; a cache entry is updated in
    place."""
    if "attn" in entry:
        c = cache_entry["attn"] if cache_entry else None
        x, _ = L.attention_block(entry["attn"], x, cfg, positions=positions,
                                 cache=c, decode_pos=decode_pos)
    if "ssm" in entry:
        c = cache_entry["ssm"] if cache_entry else None
        x, _ = mamba_block(entry["ssm"], x, cfg, cache=c)
    if "ffn" in entry:
        x = L.ffn_block(entry["ffn"], x, cfg)
    return x


def forward(params: Params, inputs: torch.Tensor,
            cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. inputs: int tokens (B, S). Returns
    (logits (B, S, V) in the activation dtype, aux_loss) — the aux loss is
    the reference's MoE term, 0 for the dense and ssm families."""
    pattern = block_pattern(cfg)
    x = L.embed_tokens(params["embed"], inputs, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i in range(num_repeats(cfg)):
        for pos in range(len(pattern)):
            entry = _layer(params["blocks"][f"pos{pos}"], i)
            x = _apply_block_position(entry, x, cfg, positions, None, None)
    logits = L.unembed(params["embed"], x, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# decode (serve_step)


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int,
                dtype: torch.dtype = torch.bfloat16) -> Params:
    """The decode cache as meta tensors (shapes and dtypes, no
    allocation): K and V of ``dtype`` for attention; for Mamba2 the conv
    window (reps, B, W-1, C) and the SSM state (reps, B, H, N, P), float32
    whatever ``dtype`` is, as in the reference."""
    reps = num_repeats(cfg)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    cache_len = seq_len
    if cfg.rolling_cache and cfg.sliding_window > 0:
        cache_len = min(seq_len, cfg.sliding_window)
    blocks = {}
    for pos, (mixer, _) in enumerate(block_pattern(cfg)):
        if mixer == "attn":
            shape = (reps, batch, cache_len, kv, hd)
            blocks[f"pos{pos}"] = {"attn": {
                "k": torch.empty(shape, dtype=dtype, device="meta"),
                "v": torch.empty(shape, dtype=dtype, device="meta")}}
        else:
            blocks[f"pos{pos}"] = {"ssm": {
                k: torch.empty((reps,) + tuple(v.shape), dtype=v.dtype,
                               device="meta")
                for k, v in mamba_cache_shape(cfg, batch).items()}}
    return blocks


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None) -> Params:
    def zeros(tree):
        return {k: (zeros(v) if isinstance(v, dict)
                    else torch.zeros_like(v, device=device))
                for k, v in tree.items()}
    return zeros(cache_specs(cfg, batch, seq_len, dtype))


def decode_step(params: Params, tokens: torch.Tensor, cache: Params,
                pos: int, cfg: ModelConfig) -> Tuple[torch.Tensor, Params]:
    """One-token decode with cache. tokens (B, 1) int; ``pos`` is the index
    of the token being decoded, a host int. Returns (logits (B, 1, V),
    cache); the cache is updated in place and returned."""
    pattern = block_pattern(cfg)
    x = L.embed_tokens(params["embed"], tokens, cfg)
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    for i in range(num_repeats(cfg)):
        for p in range(len(pattern)):
            entry = _layer(params["blocks"][f"pos{p}"], i)
            centry = _layer(cache[f"pos{p}"], i)
            x = _apply_block_position(entry, x, cfg, positions, centry, pos)
    logits = L.unembed(params["embed"], x, cfg)
    return logits, cache
