"""Token-choice top-k Mixture-of-Experts FFN with capacity-based dispatch —
the port's twin of the JAX package's ``models/moe.py``.

Dispatch scatters the kept (token, slot) rows into an (experts, capacity,
d_model) buffer, runs every expert's SwiGLU as a batched matrix product
over that buffer (``torch.bmm``: plain products, which the reference also
leaves to its compiler outside any kernel) and gathers the rows back,
weighted by the renormalised router probabilities. Two layouts, as in the
reference:

* ``moe_block``: one global capacity pool over the B * S tokens,
  ``capacity = max(int(capacity_factor * n * k / E), 8)``;
* ``moe_grouped_dispatch``: a pool a batch row, capacity at least 4.

A (token, slot) takes the next place in its expert's queue in (token,
slot) order; past the capacity it is dropped (its row adds nothing).
The router picks its top k with a stable descending sort, which breaks
ties by the lower expert index as ``jax.lax.top_k`` does (``torch.topk``
does not): in bfloat16 the router's logits tie often, and the order of
the picks decides the queue positions and so which tokens drop.

Weights are float32 and cast to the activation dtype per call, as the
reference's ``.astype(flat.dtype)``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rmsnorm, rmsnorm_spec
from repro_torch.nn.module import ParamSpec


def moe_specs(cfg: ModelConfig, stack: Tuple[int, ...] = ()) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "w_router": ParamSpec(stack + (d, e), init="fan_in"),
        "w_gate": ParamSpec(stack + (e, d, f), init="fan_in"),
        "w_up": ParamSpec(stack + (e, d, f), init="fan_in"),
        "w_down": ParamSpec(stack + (e, f, d), init="fan_in"),
        "norm": rmsnorm_spec(d, stack),
    }


def router_topk(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (N, E) -> (weights (N, k), indices (N, k), probs (N, E)):
    the float32 softmax, its k largest probabilities in descending order
    (ties to the lower index), renormalised to sum to one."""
    probs = torch.softmax(logits.float(), dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = top[..., :k], idx[..., :k]
    return weights / torch.sum(weights, dim=-1, keepdim=True), idx, probs


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e, f_e the share of tokens
    routed to expert e (summed over the k slots), P_e its mean
    probability."""
    counts = torch.bincount(idx.reshape(-1), minlength=num_experts)
    f = counts.float() / idx.shape[0]
    p = torch.mean(probs, dim=0)
    return num_experts * torch.sum(f * p)


def _dispatch(params: dict, flat: torch.Tensor, cfg: ModelConfig,
              capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One capacity pool over the n tokens of ``flat`` (n, d): (the
    experts' combined output (n, d), the aux loss)."""
    n, d = flat.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = flat @ params["w_router"].to(flat.dtype)
    weights, idx, probs = router_topk(logits, k)
    aux = load_balance_loss(probs, idx, e) * cfg.router_aux_coef

    # each (token, slot)'s place in its expert's queue, in (token, slot)
    # order: a running count along each expert's row of the one-hot
    # (E, n k) matrix (scanned along its inner dimension: along the outer
    # one, PyTorch's CUDA scan took 70% of qwen3-moe's prefill on the H100)
    expert = idx.reshape(-1)                                   # (n k,)
    seen = torch.cumsum(F.one_hot(expert, e).T.contiguous(), dim=1)
    pos = torch.gather(seen, 0, expert[None])[0] - 1
    keep = pos < capacity
    slot = torch.clamp(pos, max=capacity - 1)

    # scatter the kept rows into (E, C, d): kept places are unique and a
    # dropped row adds exact zeros, so the sum is exact in any order
    tok = torch.arange(n, device=flat.device).repeat_interleave(k)
    src = flat[tok] * keep[:, None].to(flat.dtype)
    buf = torch.zeros((e, capacity, d), dtype=flat.dtype, device=flat.device)
    buf.index_put_((expert, slot), src, accumulate=True)

    # every expert's SwiGLU over its queue
    gate = torch.bmm(buf, params["w_gate"].to(buf.dtype))
    up = torch.bmm(buf, params["w_up"].to(buf.dtype))
    out = torch.bmm(F.silu(gate) * up, params["w_down"].to(buf.dtype))

    # gather back and combine over the k slots
    gathered = out[expert, slot] * keep[:, None].to(buf.dtype)
    combined = torch.einsum("nkd,nk->nd", gathered.reshape(n, k, d),
                            weights.to(buf.dtype))
    return combined, aux


def moe_block(params: dict, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm MoE residual block over x (B, S, d). Returns (x + out, aux
    loss)."""
    if cfg.moe_grouped_dispatch:
        return _moe_block_grouped(params, x, cfg)
    b, s, d = x.shape
    n = b * s
    h = rmsnorm(x, params["norm"], cfg.norm_eps)
    capacity = max(int(cfg.capacity_factor * n * cfg.experts_per_token
                       / cfg.num_experts), 8)
    combined, aux = _dispatch(params, h.reshape(n, d), cfg, capacity)
    return x + combined.reshape(b, s, d), aux


def _moe_block_grouped(params: dict, x: torch.Tensor, cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-batch-row capacity dispatch: each row its own pool (the
    reference ``vmap``s one over the rows); the aux loss is the rows'
    mean."""
    b, s, d = x.shape
    h = rmsnorm(x, params["norm"], cfg.norm_eps)
    capacity = max(int(cfg.capacity_factor * s * cfg.experts_per_token
                       / cfg.num_experts), 4)
    rows = [_dispatch(params, h[i], cfg, capacity) for i in range(b)]
    combined = torch.stack([c for c, _ in rows])
    aux = torch.mean(torch.stack([a for _, a in rows]))
    return x + combined, aux
