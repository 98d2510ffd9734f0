"""Model registry of the port: family -> (specs, init) dispatch (the twin
of the JAX package's ``models/registry.py``; ``loss_for`` comes with the
training slice)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig


def specs_for(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.family in ("cnn", "mlp"):
        from repro_torch.models.small import small_model_specs
        return small_model_specs(cfg)
    from repro_torch.models.transformer import model_specs
    return model_specs(cfg)


def init_for(gen: torch.Generator, cfg: ModelConfig,
             device: torch.device) -> Dict[str, Any]:
    from repro_torch.nn.module import init_params
    return init_params(gen, specs_for(cfg), device)
