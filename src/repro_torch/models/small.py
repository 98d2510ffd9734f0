"""The paper's own experiment models (§IV-C) — the port's twin of the JAX
package's ``models/small.py``.

* MLP — two hidden layers (200, 200) + classifier; 199,210 params at
  28x28x1/10 classes.
* CNN — three 3x3 conv layers (32, 64, 64) with a 2x2 max pool after the
  first two, then two FC layers (hidden 64); 319,178 params at 32x32x3.

Parameters keep the reference layout and names — ``w{i}``/``fc*_w`` are
``(in, out)``, ``conv{i}_w`` is HWIO, activations are NHWC — so weights
load one-to-one (``params_from_numpy``/``params_to_numpy``).

``*_apply_lanes`` are the lane-stacked forwards the fused engine trains
with: every leaf carries a leading lane axis C and lane c only ever reads
lane c's weights, so one autograd pass over the lane-summed loss gives
every lane its own gradient. The products are the plain ones the
reference leaves to XLA under ``vmap``: ``torch.bmm`` for the FC layers,
and for the convolutions one grouped ``F.conv2d`` (``groups=C``) over the
lanes' channels side by side. The CNN computes in NCHW and puts the
activations back in NHWC order before the flatten into ``fc0_w``, whose
rows the reference orders (h, w, c).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.module import ParamSpec, init_params

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# MLP


def mlp_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d_in = cfg.image_size * cfg.image_size * cfg.image_channels
    dims = (d_in,) + tuple(cfg.mlp_hidden) + (cfg.num_classes,)
    specs = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        specs[f"w{i}"] = ParamSpec((a, b), init="fan_in")
        specs[f"b{i}"] = ParamSpec((b,), init="zeros")
    return specs


def _mlp_features_lanes(params: Params, images: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    x = images.reshape(images.shape[0], images.shape[1], -1)
    for i in range(len(cfg.mlp_hidden)):
        x = torch.relu(torch.bmm(x, params[f"w{i}"])
                       + params[f"b{i}"].unsqueeze(1))
    return x


def mlp_apply_lanes(params: Params, images: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Logits of C independent MLPs: leaves (C, ...), images (C, B, ...)
    -> (C, B, classes)."""
    n = len(cfg.mlp_hidden)
    x = _mlp_features_lanes(params, images, cfg)
    return torch.bmm(x, params[f"w{n}"]) + params[f"b{n}"].unsqueeze(1)


# ---------------------------------------------------------------------------
# CNN


def cnn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    chans = (cfg.image_channels,) + tuple(cfg.cnn_channels)
    specs = {}
    for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
        specs[f"conv{i}_w"] = ParamSpec((3, 3, cin, cout), init="fan_in")
        specs[f"conv{i}_b"] = ParamSpec((cout,), init="zeros")
    # spatial size after two 2x2 pools (ceil division for odd sizes)
    s = cfg.image_size
    for _ in range(2):
        s = (s + 1) // 2
    feat = s * s * cfg.cnn_channels[-1]
    specs["fc0_w"] = ParamSpec((feat, 64), init="fan_in")
    specs["fc0_b"] = ParamSpec((64,), init="zeros")
    specs["fc1_w"] = ParamSpec((64, cfg.num_classes), init="fan_in")
    specs["fc1_b"] = ParamSpec((cfg.num_classes,), init="zeros")
    return specs


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    """The reference's "SAME" 2x2/2 max pool on NCHW: an odd edge is
    padded with -inf at its end, which is what ``ceil_mode`` computes."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _conv_lanes(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """"SAME" 3x3 convolution of C lanes at once: ``x`` (B, C*Cin, H, W)
    holds lane c's channels at c*Cin.., ``w`` (C, 3, 3, Cin, Cout) the
    lanes' HWIO kernels, ``b`` (C, Cout); returns (B, C*Cout, H, W)."""
    C, kh, kw, cin, cout = w.shape
    wk = w.permute(0, 4, 3, 1, 2).reshape(C * cout, cin, kh, kw)
    return F.conv2d(x, wk, b.reshape(C * cout), padding=(kh // 2, kw // 2),
                    groups=C)


def _cnn_features_lanes(params: Params, images: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    """Penultimate features of C CNNs: images (C, B, H, W, Cin) NHWC ->
    (C, B, 64)."""
    C, B, H, W, cin = images.shape
    x = images.permute(1, 0, 4, 2, 3).reshape(B, C * cin, H, W)
    for i in range(len(cfg.cnn_channels)):
        x = torch.relu(_conv_lanes(x, params[f"conv{i}_w"],
                                   params[f"conv{i}_b"]))
        if i < 2:
            x = _maxpool2(x)
    _, _, h, w = x.shape
    # back to the reference's NHWC order: fc0_w's rows are (h, w, c)
    x = x.view(B, C, -1, h, w).permute(1, 0, 3, 4, 2).reshape(C, B, -1)
    return torch.relu(torch.bmm(x, params["fc0_w"])
                      + params["fc0_b"].unsqueeze(1))


def cnn_apply_lanes(params: Params, images: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Logits of C independent CNNs: leaves (C, ...), images
    (C, B, H, W, Cin) -> (C, B, classes)."""
    x = _cnn_features_lanes(params, images, cfg)
    return torch.bmm(x, params["fc1_w"]) + params["fc1_b"].unsqueeze(1)


# ---------------------------------------------------------------------------
# family dispatch and the shared classifier loss

def _one_lane(params: Params) -> Params:
    return {k: v.unsqueeze(0) for k, v in params.items()}


def mlp_apply(params: Params, images: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Logits of ONE MLP: images (N, ...) -> (N, classes)."""
    return mlp_apply_lanes(_one_lane(params), images.unsqueeze(0), cfg)[0]


def cnn_apply(params: Params, images: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Logits of ONE CNN: images (N, H, W, Cin) -> (N, classes)."""
    return cnn_apply_lanes(_one_lane(params), images.unsqueeze(0), cfg)[0]


_SPECS = {"cnn": cnn_specs, "mlp": mlp_specs}
_APPLY = {"cnn": cnn_apply, "mlp": mlp_apply}
_APPLY_LANES = {"cnn": cnn_apply_lanes, "mlp": mlp_apply_lanes}
_FEATURES_LANES = {"cnn": _cnn_features_lanes, "mlp": _mlp_features_lanes}


def small_model_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    return _SPECS[cfg.family](cfg)


def small_model_apply(params: Params, images: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    return _APPLY[cfg.family](params, images, cfg)


def small_model_apply_lanes(params: Params, images: torch.Tensor,
                            cfg: ModelConfig) -> torch.Tensor:
    return _APPLY_LANES[cfg.family](params, images, cfg)


def small_model_features(params: Params, images: torch.Tensor,
                         cfg: ModelConfig) -> torch.Tensor:
    """Penultimate-layer representation of ONE model (MOON's contrastive
    loss reads it)."""
    return small_model_features_lanes(_one_lane(params), images.unsqueeze(0),
                                      cfg)[0]


def small_model_features_lanes(params: Params, images: torch.Tensor,
                               cfg: ModelConfig) -> torch.Tensor:
    """Penultimate-layer representations of C lanes: leaves (C, ...),
    images (C, B, ...) -> (C, B, features)."""
    return _FEATURES_LANES[cfg.family](params, images, cfg)


def init_small_model(gen: torch.Generator, cfg: ModelConfig,
                     device: torch.device) -> Params:
    return init_params(gen, small_model_specs(cfg), device)


def head_param_names(cfg: ModelConfig) -> frozenset:
    """Names of the classifier-head leaves — the final linear layer that
    maps features to class logits (the leaves head-only personalization
    trains)."""
    if cfg.family == "mlp":
        n = len(cfg.mlp_hidden)
        return frozenset((f"w{n}", f"b{n}"))
    return frozenset(("fc1_w", "fc1_b"))


def head_grad_mask(params: Params, cfg: ModelConfig) -> Params:
    """Params-shaped 0/1 float32 mask: 1 on the classifier-head leaves, 0
    elsewhere."""
    head = head_param_names(cfg)
    return {k: torch.full(v.shape, float(k in head), dtype=torch.float32,
                          device=v.device)
            for k, v in params.items()}


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
    return _cross_entropy(small_model_apply(params, batch["images"], cfg),
                          batch["labels"].long())


def classifier_loss_lanes(params: Params, batch: Mapping[str, torch.Tensor],
                          cfg: ModelConfig) -> torch.Tensor:
    """(C,) per-lane mean cross-entropy of a lane stack on its (C, B)
    batches."""
    return _cross_entropy(
        small_model_apply_lanes(params, batch["images"], cfg),
        batch["labels"].long())


def classifier_loss_and_features_lanes(
        params: Params, batch: Mapping[str, torch.Tensor],
        cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """``classifier_loss_lanes`` and the penultimate features it read,
    (C,) and (C, B, features), from one forward (MOON's loss reads
    both)."""
    z = small_model_features_lanes(params, batch["images"], cfg)
    if cfg.family == "mlp":
        w, b = (f"w{len(cfg.mlp_hidden)}", f"b{len(cfg.mlp_hidden)}")
    else:
        w, b = "fc1_w", "fc1_b"
    logits = torch.bmm(z, params[w]) + params[b].unsqueeze(1)
    return _cross_entropy(logits, batch["labels"].long()), z


def classifier_accuracy(params: Params, images: torch.Tensor,
                        labels: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    logits = small_model_apply(params, images, cfg)
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
