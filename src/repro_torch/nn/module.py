"""Minimal functional parameter specs (the port's twin of the JAX
package's ``nn/module.py``).

A model is described by a dict of :class:`ParamSpec` leaves (shape +
initializer); ``init_params`` materializes it from an explicit
``torch.Generator``. Leaves are drawn in sorted-name order — the order the
JAX package flattens a dict pytree in. The JAX package draws each leaf from
its own split ``jax.random`` key, which torch cannot replay, so the same
seed gives different weights in the two packages: tests carry weights
across with ``models.small.params_from_numpy`` instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "fan_in"       # fan_in | zeros (the MLP's two kinds)
    scale: float = 1.0
    dtype: torch.dtype = torch.float32


def _init_leaf(gen: torch.Generator, spec: ParamSpec) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype)
    if spec.init == "fan_in":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / math.sqrt(max(fan_in, 1))
        return std * torch.randn(spec.shape, generator=gen, dtype=spec.dtype)
    raise NotImplementedError(
        f"init {spec.init!r} is not ported yet (the LM zoo's kinds come "
        "with ROADMAP A10)")


def init_params(gen: torch.Generator, specs: Dict[str, ParamSpec],
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Materialize ``specs`` on ``device``. The draws happen on the
    generator's own (CPU) device, so a seed gives the same weights on every
    device."""
    return {name: _init_leaf(gen, specs[name]).to(device)
            for name in sorted(specs)}

