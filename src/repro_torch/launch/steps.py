"""Training and serving steps of the port (the twin of the JAX package's
``launch/steps.py``: ``make_train_step`` with its cloud sync,
``_make_serial_train_step``, ``make_prefill_step``, ``make_serve_step``).

The reference builds its steps for a device mesh and jits them with
sharded parameters. The port runs on one card: there is no mesh and no
sharding, and the steps are plain functions that launch the model's matrix
products and the kernels eagerly.

A training state is ``{"params", "mom", "step"}`` as in the reference, but
each of ``params`` and ``mom`` is one flat buffer: ``(C, P)`` for the
pipelined ring (client lane c's model in row c) and ``(P,)`` for the
serial one, every leaf laid out in sorted-name order (``train_layout``;
``state_tree`` gives the nested views). ``train_state_from_numpy`` loads
the reference's state. A step updates the buffers in place (the
reference returns new arrays; in place saves a copy of the whole state a
step) and returns the state with its new ring order and step count.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.kernels.fused_sgd.ops import fused_sgd_lanes
from repro_torch.models.transformer import (
    block_pattern, decode_step, forward, lm_loss, lm_params_from_numpy,
    model_specs,
)
from repro_torch.utils.tree import Layout, flatten_tree, nest_tree, unravel

State = Dict[str, Any]
Batch = Mapping[str, torch.Tensor]


# ---------------------------------------------------------------------------
# the training state


def train_layout(cfg: ModelConfig) -> Layout:
    """(``/``-joined name, per-model shape) of every parameter leaf of
    ``cfg``'s model, in sorted-name order: the layout of a state's flat
    buffers."""
    specs = flatten_tree(model_specs(cfg))
    return tuple((k, tuple(specs[k].shape)) for k in sorted(specs))


def state_tree(flat: torch.Tensor, layout: Layout) -> Dict[str, Any]:
    """The nested parameter tree of a flat ``(..., P)`` buffer: views whose
    leaves keep the leading (client) axes, as the reference's stacked
    leaves do."""
    return nest_tree(unravel(flat, layout))


def train_state_from_numpy(state: Mapping[str, Any],
                           device=None) -> State:
    """The reference's training state ``{"params", "mom", "step"}`` (its
    nested trees of numpy leaves, e.g. ``jax.device_get(state)``) as the
    port's: each tree raveled into one flat buffer on ``device`` (default
    ``cuda``) in ``train_layout`` order, the client axes kept in front
    (read off ``embed/final_norm``, one-dimensional per model), in the
    leaves' own dtype (bfloat16 or float32)."""
    device = torch.device("cuda" if device is None else device)

    def flat(tree):
        leaves = flatten_tree(tree)
        dtype = (torch.bfloat16
                 if str(leaves["embed/final_norm"].dtype) == "bfloat16"
                 else torch.float32)
        lead = np.shape(leaves["embed/final_norm"])[:-1]
        as_f32 = flatten_tree(lm_params_from_numpy(tree, device))
        return torch.cat([as_f32[k].reshape(*lead, -1) for k in sorted(as_f32)],
                         dim=-1).to(dtype)

    return {"params": flat(state["params"]), "mom": flat(state["mom"]),
            "step": int(np.asarray(state["step"]))}


# ---------------------------------------------------------------------------
# steps


def lane_grads(flat: torch.Tensor, batch: Batch, cfg: ModelConfig,
               layout: Layout, remat: bool
               ) -> Tuple[torch.Tensor, Sequence[torch.Tensor]]:
    """Each client lane's loss on its own batch and the gradient of that
    loss: ``flat`` (C, P), batch leaves (C, B, S). Returns the (C,) losses
    and the gradient as ``layout``'s leaves, each a contiguous (C, *shape)
    tensor (what ``fused_sgd_lanes`` reads in place). The lanes run one
    after another through ``lm_loss``; one backward of their sum gives
    every lane its own gradient, each leaf's lanes stacked once by
    ``unbind``'s backward."""
    C = flat.shape[0]
    views = unravel(flat, layout)
    leaves = [views[name].detach().requires_grad_() for name, _ in layout]
    per_lane = [leaf.unbind(0) for leaf in leaves]
    losses = []
    for c in range(C):
        params = nest_tree({name: lanes[c] for (name, _), lanes
                            in zip(layout, per_lane)})
        losses.append(lm_loss(params, {k: v[c] for k, v in batch.items()},
                              cfg, remat=remat))
    losses = torch.stack(losses)
    grads = torch.autograd.grad(losses.sum(), leaves)
    return losses.detach(), [g.contiguous() for g in grads]


def _check_trainable(cfg: ModelConfig, tcfg: TrainConfig) -> None:
    if cfg.family == "ssm":
        raise NotImplementedError(
            "training the ssm family needs a backward of the SSD scan "
            "kernel, which is not ported yet (ROADMAP A10.5)")
    block_pattern(cfg)           # the unported families raise (ROADMAP A10)
    if tcfg.param_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"param_dtype {tcfg.param_dtype!r} is not float32 "
                         "or bfloat16")
    if tcfg.fused_sgd and tcfg.param_dtype != "float32":
        raise NotImplementedError(
            "fused_sgd with param_dtype='bfloat16': the port's fused_sgd "
            "kernel is float32-only (ROADMAP A10.6); the unfused bfloat16 "
            "step runs in torch ops")
    if tcfg.ring_mode not in ("pipelined", "serial"):
        raise ValueError(f"ring_mode {tcfg.ring_mode!r} is not pipelined or "
                         "serial")


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig
                    ) -> Tuple[Callable[[State, Batch], Tuple[State,
                                                               torch.Tensor]],
                               Callable[[State], State]]:
    """FedSR train step + cloud sync step (``ring_mode``: pipelined |
    serial). ``train_step(state, batch) -> (state, mean loss)`` with batch
    ``{"inputs", "labels"}`` of (C, B, S) ints, C the client lanes.

    Pipelined: every lane takes one SGD step on its own batch; then the
    ring hop moves lane c's model to lane c + 1 (``torch.roll`` of the
    params, and of the momentum when ``hop_momentum``). ``cloud_sync``
    (eq. 11, every ``cloud_sync_every`` steps in ``train_loop``) sets every
    lane to the lanes' mean and zeroes the momentum.

    The update follows the reference's two forms exactly (ROADMAP C2: hold
    each against its own reference path): unfused, ``m' = mu m + g`` and
    ``p' = p - lr m'`` per leaf in torch ops (p - lr m' in float32, then
    rounded to ``param_dtype``); with ``fused_sgd``, one ``fused_sgd_lanes``
    launch over the (C, P) state reading the gradient leaves in place.

    Like the reference's LM step, it ignores ``optimizer``,
    ``weight_decay``, ``compute_dtype``, ``dp_clip`` and ``dp_noise_mult``
    (ROADMAP C11). Raises ``NotImplementedError`` for the ssm family
    (A10.5), the unported families (A10) and ``fused_sgd`` with bfloat16
    parameters (A10.6)."""
    _check_trainable(cfg, tcfg)
    layout = train_layout(cfg)
    remat = tcfg.remat != "none"
    mu, lr = tcfg.momentum, tcfg.learning_rate

    def update(p: torch.Tensor, m: torch.Tensor, grads) -> None:
        """One momentum step of the (C, P) buffers ``p``, ``m`` in place."""
        lr_t = torch.tensor(lr, dtype=torch.float32, device=p.device)
        if tcfg.fused_sgd:
            ok = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
            fused_sgd_lanes(p, list(grads), m, ok, lr_t.reshape(1),
                            reset=False, momentum=mu)
            return
        ps, ms = unravel(p, layout), unravel(m, layout)
        for (name, _), g in zip(layout, grads):
            mv, pv = ms[name], ps[name]
            mv.mul_(mu).add_(g.to(mv.dtype))
            pv.copy_(pv.float() - lr_t * mv.float())

    if tcfg.ring_mode == "serial":
        return _make_serial_train_step(cfg, layout, remat, update)

    def train_step(state: State, batch: Batch):
        p, m = state["params"], state["mom"]
        losses, grads = lane_grads(p, batch, cfg, layout, remat)
        update(p, m, grads)
        del grads
        # ring hop: the model moves to the next ring position; momentum
        # hops with it in the baseline, stays with the device without
        # hop_momentum (paper Alg. 1 keeps optimizer state on the device)
        p = torch.roll(p, 1, 0)
        if tcfg.hop_momentum:
            m = torch.roll(m, 1, 0)
        return ({"params": p, "mom": m, "step": state["step"] + 1},
                losses.mean())

    def cloud_sync(state: State) -> State:
        # eq. 11: the cloud aggregates the ring models (uniform shards ->
        # plain mean); momentum restarts after aggregation (fresh visit)
        p = state["params"]
        mean = torch.mean(p, dim=0, keepdim=True)
        return {"params": mean.expand_as(p).contiguous(),
                "mom": torch.zeros_like(state["mom"]), "step": state["step"]}

    return train_step, cloud_sync


def _make_serial_train_step(cfg: ModelConfig, layout: Layout, remat: bool,
                            update):
    """Literal Algorithm 1 inner loop: ONE logical model (a (P,) state)
    visits the C clients' batches in ring order inside the step, each visit
    one SGD step on that client's batch. Cloud sync is the identity (a
    single chain)."""

    def train_step(state: State, batch: Batch):
        p, m = state["params"][None], state["mom"][None]    # (1, P) views
        losses = []
        for c in range(batch["inputs"].shape[0]):
            loss, grads = lane_grads(
                p, {k: v[c:c + 1] for k, v in batch.items()}, cfg, layout,
                remat)
            update(p, m, grads)
            losses.append(loss[0])
        return ({"params": state["params"], "mom": state["mom"],
                 "step": state["step"] + 1}, torch.stack(losses).mean())

    def cloud_sync(state: State) -> State:
        return state

    return train_step, cloud_sync


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
