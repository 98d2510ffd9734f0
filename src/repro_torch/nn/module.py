"""Minimal functional parameter specs (the port's twin of the JAX
package's ``nn/module.py``).

A model is described by a *spec tree*: a nested dict whose leaves are
:class:`ParamSpec` (shape + initializer); ``init_params`` materializes it
from an explicit ``torch.Generator``. Leaves are drawn in sorted-key order,
depth first — the order the JAX package flattens a dict pytree in. The JAX
package draws each leaf from its own split ``jax.random`` key, which torch
cannot replay, so the same seed gives different weights in the two
packages: tests carry weights across with ``models.small.params_from_numpy``
and ``models.transformer.lm_params_from_numpy`` instead.

The reference's logical sharding axes have no counterpart on one card and
are left out of the port's ``ParamSpec``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

SpecTree = Dict[str, Any]       # nested dict with ParamSpec leaves


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"       # normal | zeros | ones | embed | fan_in
    scale: float = 1.0
    dtype: torch.dtype = torch.float32


def _init_leaf(gen: torch.Generator, spec: ParamSpec) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=gen.device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=gen.device)
    if spec.init == "normal":
        std = spec.scale
    elif spec.init == "embed":
        std = 0.02 * spec.scale
    elif spec.init == "fan_in":
        # the reference's rule, kept exactly: fan_in is shape[-2], which for
        # a (L, d, h, hd) projection is h, not d
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    x = torch.randn(spec.shape, generator=gen, dtype=spec.dtype,
                    device=gen.device)
    return x.mul_(std)


def init_params(gen: torch.Generator, specs: SpecTree,
                device: torch.device) -> Dict[str, Any]:
    """Materialize the spec tree ``specs`` on ``device``. The draws happen
    on the generator's own device, so a CPU generator gives the same
    weights on every device, and a CUDA generator draws a model too large
    for a quick CPU init straight on the card."""
    out = {}
    for name in sorted(specs):
        s = specs[name]
        out[name] = (_init_leaf(gen, s).to(device) if isinstance(s, ParamSpec)
                     else init_params(gen, s, device))
    return out


def param_count(specs: SpecTree) -> int:
    return sum(math.prod(s.shape) if isinstance(s, ParamSpec)
               else param_count(s) for s in specs.values())
