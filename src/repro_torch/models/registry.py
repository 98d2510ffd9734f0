"""Model registry of the port: family -> (specs, init, loss) dispatch
(the twin of the JAX package's ``models/registry.py``)."""
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


def loss_for(cfg: ModelConfig):
    """``loss(params, batch, cfg)`` for the config's family: the
    classifier's cross-entropy for cnn/mlp, ``lm_loss`` otherwise."""
    if cfg.family in ("cnn", "mlp"):
        from repro_torch.models.small import classifier_loss
        return classifier_loss
    from repro_torch.models.transformer import lm_loss
    return lm_loss
