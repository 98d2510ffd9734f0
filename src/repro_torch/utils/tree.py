"""Parameter-dict helpers of the port (the twin of the JAX package's
``utils/tree.py``, for the dicts of tensors the port uses as pytrees).

``ravel_params``/``unravel`` are the port's ``ravel_pytree``: leaves are
laid out in sorted-name order — the order ``jax.flatten_util.ravel_pytree``
uses for a dict — so a raveled vector lines up element for element across
the two packages. ``unravel`` returns views, so a ``(C, P)`` lane stack is
one contiguous buffer that every per-leaf view writes through.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Sequence, Tuple

import torch

Layout = Tuple[Tuple[str, Tuple[int, ...]], ...]


def tree_bytes(params: Dict[str, torch.Tensor]) -> int:
    return sum(x.numel() * x.element_size() for x in params.values())


def layout_of(params: Dict[str, torch.Tensor]) -> Layout:
    """The (name, shape) sequence of a parameter dict, in sorted order."""
    return tuple((k, tuple(params[k].shape)) for k in sorted(params))


def ravel_params(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One contiguous flat vector of every leaf, in ``layout_of`` order."""
    return torch.cat([params[k].reshape(-1) for k, _ in layout_of(params)])


def unravel(flat: torch.Tensor, layout: Layout) -> Dict[str, torch.Tensor]:
    """Per-leaf views of a ``(..., P)`` flat buffer: leaf ``k`` becomes
    ``(..., *shape_k)``. Leading axes (the lane axis C) are kept."""
    lead = flat.shape[:-1]
    out, off = {}, 0
    for name, shape in layout:
        n = math.prod(shape)
        out[name] = flat[..., off:off + n].view(*lead, *shape)
        off += n
    if off != flat.shape[-1]:
        raise ValueError(f"flat width {flat.shape[-1]} != layout size {off}")
    return out


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested dict's leaves under ``/``-joined names (an LM tree's
    ``blocks/pos0/attn/wq``); a flat dict comes back as it is."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def nest_tree(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of ``flatten_tree``: ``/``-joined names as nested dicts."""
    out: Dict[str, Any] = {}
    for name, v in flat.items():
        *path, leaf = name.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def weighted_sum(vectors: Sequence[torch.Tensor],
                 weights: Sequence[float]) -> torch.Tensor:
    """``sum_i w_i * v_i`` in the reference's order (``tree_weighted_sum``,
    the cloud aggregation of eq. 11): ``w_0 * v_0``, then ``+ w_i * v_i``
    one term at a time, each product and sum rounded in float32."""
    if len(vectors) != len(weights) or not vectors:
        raise ValueError(f"{len(vectors)} vectors for {len(weights)} weights")
    out = vectors[0] * weights[0]
    for v, w in zip(vectors[1:], weights[1:]):
        out = out + w * v
    return out
