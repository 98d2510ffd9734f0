"""Serving steps of the port (the twin of the JAX package's
``launch/steps.py::make_prefill_step`` and ``make_serve_step``).

The reference builds its steps for a device mesh and jits them with
sharded parameters. The port runs on one card: there is no mesh and no
sharding, and the steps are plain functions of the parameters, eagerly
launching the model's matrix products and the attention kernels.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import decode_step, forward


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, inputs (B, S) int) -> logits (B, S, V)``."""
    def prefill_step(params, inputs):
        logits, _ = forward(params, inputs, cfg)
        return logits

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """``serve_step(params, cache, tokens (B, 1), pos: int) -> (logits
    (B, 1, V), cache)``; the cache is updated in place."""
    def serve_step(params, cache, tokens, pos):
        return decode_step(params, tokens, cache, pos, cfg)

    return serve_step
