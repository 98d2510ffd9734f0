"""The paper's MLP (§IV-C) — the port's twin of the JAX package's
``models/small.py``.

Parameters keep the reference layout and names — ``w{i}`` is ``(in, out)``,
``b{i}`` is ``(out,)`` — so weights load one-to-one
(``params_from_numpy``/``params_to_numpy``). ``mlp_apply_lanes`` is the
lane-stacked forward the fused engine trains with: every leaf carries a
leading lane axis C and each layer is one ``torch.bmm``, the plain matrix
product the reference leaves to XLA under ``vmap``. The CNN is ROADMAP A3.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.module import ParamSpec, init_params

Params = Dict[str, torch.Tensor]


def _require_mlp(cfg: ModelConfig) -> None:
    if cfg.family != "mlp":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP A3: "
            "only the paper MLP runs in the port)")


def mlp_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d_in = cfg.image_size * cfg.image_size * cfg.image_channels
    dims = (d_in,) + tuple(cfg.mlp_hidden) + (cfg.num_classes,)
    specs = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        specs[f"w{i}"] = ParamSpec((a, b), init="fan_in")
        specs[f"b{i}"] = ParamSpec((b,), init="zeros")
    return specs


def mlp_apply(params: Params, images: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Logits of ONE model: images (N, ...) -> (N, classes)."""
    x = images.reshape(images.shape[0], -1)
    n = len(cfg.mlp_hidden)
    for i in range(n + 1):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n:
            x = torch.relu(x)
    return x


def mlp_apply_lanes(params: Params, images: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Logits of C independent models: leaves (C, ...), images
    (C, B, ...) -> (C, B, classes). Lane c only ever reads lane c's
    weights, so one autograd pass over the lane-summed loss gives every
    lane its own gradient."""
    x = images.reshape(images.shape[0], images.shape[1], -1)
    n = len(cfg.mlp_hidden)
    for i in range(n + 1):
        x = torch.bmm(x, params[f"w{i}"]) + params[f"b{i}"].unsqueeze(1)
        if i < n:
            x = torch.relu(x)
    return x


def init_small_model(gen: torch.Generator, cfg: ModelConfig,
                     device: torch.device) -> Params:
    _require_mlp(cfg)
    return init_params(gen, mlp_specs(cfg), device)


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over the batch axis (-2) of logsumexp - label logit, in the
    reference's arithmetic (``classifier_loss``)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels.unsqueeze(-1)).squeeze(-1)
    return torch.mean(lse - label_logit, dim=-1)


def classifier_loss(params: Params, batch: Mapping[str, torch.Tensor],
                    cfg: ModelConfig) -> torch.Tensor:
    """Scalar mean cross-entropy of one model on one batch."""
    _require_mlp(cfg)
    return _cross_entropy(mlp_apply(params, batch["images"], cfg),
                          batch["labels"].long())


def classifier_loss_lanes(params: Params, batch: Mapping[str, torch.Tensor],
                          cfg: ModelConfig) -> torch.Tensor:
    """(C,) per-lane mean cross-entropy of a lane stack on its (C, B)
    batches."""
    _require_mlp(cfg)
    return _cross_entropy(mlp_apply_lanes(params, batch["images"], cfg),
                          batch["labels"].long())


def classifier_accuracy(params: Params, images: torch.Tensor,
                        labels: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    _require_mlp(cfg)
    logits = mlp_apply(params, images, cfg)
    return torch.mean((torch.argmax(logits, dim=-1) == labels).float())


def params_from_numpy(tree: Mapping[str, np.ndarray],
                      device: torch.device) -> Params:
    """The JAX package's parameter dict (as numpy arrays, e.g.
    ``jax.device_get(w_glob)``) as the port's float32 tensors on
    ``device`` — same names, same layout."""
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in sorted(tree.items())}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_numpy``."""
    return {k: v.detach().cpu().numpy().copy() for k, v in sorted(params.items())}
