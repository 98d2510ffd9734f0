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
state for Mamba2) is updated in place. ``decode_step_lanes`` decodes a
batch whose every request runs under its own model of a fleet. The other
families (moe, hybrid, vlm, audio) raise ``NotImplementedError`` naming
their ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.mamba2 import (
    mamba_block, mamba_block_lanes, mamba_cache_shape, mamba_specs,
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


# ---------------------------------------------------------------------------
# fleet decode: every request under its own model


class LaneRows(Mapping):
    """Request rows of a fleet's stacked tree, gathered when read.

    ``tree`` holds ``(K, ...)`` leaves (one model a row: views of a fleet's
    ``(K, P)`` stack) and ``lanes`` (B,) picks request b's row. Reading a
    leaf gathers its B rows with one ``index_select`` (of layer ``layer``
    when the leaf is stacked over layers, at dim 1), so a step holds at
    most the leaf being used; ``meter[0]`` adds up the bytes gathered."""

    def __init__(self, tree: Mapping[str, Any], lanes: torch.Tensor,
                 layer: Optional[int] = None, meter: Optional[list] = None):
        self._tree, self._lanes, self._layer = tree, lanes, layer
        self._meter = [0] if meter is None else meter

    def __getitem__(self, key: str):
        v = self._tree[key]
        if isinstance(v, Mapping):
            return LaneRows(v, self._lanes, self._layer, self._meter)
        if self._layer is not None:
            v = v[:, self._layer]
        out = torch.index_select(v, 0, self._lanes)
        self._meter[0] += out.numel() * out.element_size()
        return out

    def __contains__(self, key) -> bool:     # no gather to test a key
        return key in self._tree

    def __iter__(self) -> Iterator[str]:
        return iter(self._tree)

    def __len__(self) -> int:
        return len(self._tree)


def _apply_block_position_lanes(entry, x, cfg, positions, cache_entry,
                                decode_pos) -> torch.Tensor:
    """``_apply_block_position``'s decode with a request axis on every
    leaf."""
    if "attn" in entry:
        x, _ = L.attention_block_lanes(entry["attn"], x, cfg,
                                       positions=positions,
                                       cache=cache_entry["attn"],
                                       decode_pos=decode_pos)
    if "ssm" in entry:
        x, _ = mamba_block_lanes(entry["ssm"], x, cfg,
                                 cache=cache_entry["ssm"])
    if "ffn" in entry:
        x = L.ffn_block_lanes(entry["ffn"], x, cfg)
    return x


def decode_step_lanes(stack: Params, lanes: torch.Tensor,
                      tokens: torch.Tensor, cache: Params, pos: int,
                      cfg: ModelConfig, meter: Optional[list] = None
                      ) -> Tuple[torch.Tensor, Params]:
    """``decode_step`` for a batch whose request b runs under model
    ``lanes[b]`` of a fleet: ``stack`` is the fleet's tree of ``(K, ...)``
    leaves. Each layer's B rows are gathered just before the layer runs
    (``LaneRows``) and each embedding row is indexed in the fleet's
    tables, so the step never holds the B models whole (the reference
    gathers them once a call and ``vmap``s ``decode_step``). The cache is
    ``init_cache(cfg, B, ...)``'s, (reps, B, T, ...), one row a request;
    the reference's fleet cache is (B, reps, 1, T, ...), and no checkpoint
    or test reads a cache across the packages. Returns (logits (B, 1, V),
    cache); ``meter[0]`` adds up the bytes gathered."""
    meter = [0] if meter is None else meter
    pattern = block_pattern(cfg)
    embed = stack["embed"]["embed"]
    x = L.embed_tokens_lanes(embed, lanes, tokens, cfg)
    meter[0] += x.numel() * embed.element_size()
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    for i in range(num_repeats(cfg)):
        for p in range(len(pattern)):
            entry = LaneRows(stack["blocks"][f"pos{p}"], lanes, i, meter)
            centry = _layer(cache[f"pos{p}"], i)
            x = _apply_block_position_lanes(entry, x, cfg, positions, centry,
                                            pos)
    logits = L.unembed_lanes(LaneRows(stack["embed"], lanes, None, meter), x,
                             cfg)
    return logits, cache
