"""Architecture config registry of the port: ``--arch <id>`` resolution
and smoke reduction (the twin of the JAX package's ``configs/registry.py``).

Every id of the JAX package's registry resolves, with the same fields.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

ARCH_IDS = (
    "musicgen-large",
    "jamba-v0.1-52b",
    "stablelm-12b",
    "granite-8b",
    "llava-next-mistral-7b",
    "deepseek-7b",
    "qwen3-moe-30b-a3b",
    "phi3.5-moe-42b-a6.6b",
    "yi-9b",
    "mamba2-2.7b",
    # the paper's own experiment models
    "fedsr-cnn",
    "fedsr-mlp",
)

_MODULE_FOR = {
    "musicgen-large": "musicgen_large",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "stablelm-12b": "stablelm_12b",
    "granite-8b": "granite_8b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "deepseek-7b": "deepseek_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "yi-9b": "yi_9b",
    "mamba2-2.7b": "mamba2_2_7b",
    "fedsr-mlp": "fedsr_mlp",
    "fedsr-cnn": "fedsr_cnn",
}


def _module(arch: str):
    if arch not in _MODULE_FOR:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULE_FOR[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def reduce_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family variant: <=2 pattern periods, d_model<=512,
    <=4 experts — runs one forward/train step on CPU."""
    changes = {
        "d_model": 256,
        "d_ff": 512 if cfg.d_ff > 0 else 0,
        "vocab_size": min(cfg.vocab_size, 512),
        "num_heads": 4 if cfg.num_heads else 0,
        "num_kv_heads": min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        "head_dim": 64 if cfg.num_heads else 0,
        "ssm_state": min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        "ssm_headdim": 64 if cfg.ssm_state else 64,
        "ssm_chunk": 32,
        "num_experts": min(cfg.num_experts, 4) if cfg.num_experts else 0,
        "experts_per_token": (min(cfg.experts_per_token, 2)
                              if cfg.experts_per_token else 0),
        "sliding_window": (min(cfg.sliding_window, 16)
                           if cfg.sliding_window else 0),
    }
    if cfg.family == "hybrid":
        # shrink the jamba pattern period from 8 to 2: [ssm+dense, attn+moe]
        changes.update(num_layers=2, attn_every=2, attn_offset=1,
                       moe_every=2, moe_offset=1)
    else:
        period = 1
        changes["num_layers"] = 2 * period
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
