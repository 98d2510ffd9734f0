"""Post-global personalization: every client fine-tunes the final global
model on its own shard (the port's twin of the JAX package's
``core/personalize.py``; ``FLConfig.personalize``).

The stage runs after the last global round, outside the round loop, on
the training stack:

* **lanes** — each block of clients is one ``LocalTrainer.
  train_many_fused`` call (broadcast seed, no reduce; one dispatch),
  gathering its batches from the block's data plane. The fine-tune is
  always the plain loss with the momentum update, whatever the
  experiment's algorithm, so it goes through ``fused_sgd`` when
  ``use_fused_sgd``; ``mode="head"`` masks the body's gradients to zero
  (``LocalTrainer(grad_mask=)``);
* **stores** — blocks stage through the experiment's ``ClientStore``
  (``FLConfig.store``): under ``store="host"``/``"stream"`` only the
  block's shards go to the device, and the next block's arena prefetches
  on the store's staging thread while the current block's steps run;
* **the fleet** — the personalized models accumulate in a host ``(K, P)``
  numpy arena (``core.state.host_stack``) through ``unstage_rows``, and
  persist as ``personalized.msgpack`` through ``pack_client_rows`` in the
  ``algo_state.msgpack`` layout (``"i:<id>"`` keys), which either package
  reads.

Per-client evaluation is one lane-stacked forward a block (each client's
``eval_per_client`` label-matched draws from the global test pool, in
proportion to its own shard's label histogram) plus one forward of the
global model over the same draws, so the lift is measured like for like.

Everything draws from ``PersonalizeConfig.seed`` (plans from
``default_rng((seed, 1))``, eval draws from ``default_rng((seed, 2))``,
each in fleet-id order, block by block), never from the experiment's
stream, so a personalize-off run is bit-equal to one without the stage.
The stage's trainer is its own: under DP-SGD its generator starts again
from ``dp_seed``, and no privacy ledger is charged for its steps.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint.io import restore, save
from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.core.local import LocalTrainer
from repro_torch.core.state import (
    host_stack, pack_client_rows, unpack_client_rows, unstage_rows,
)
from repro_torch.data.pipeline import plan_epoch_indices, stack_plan_indices
from repro_torch.data.store import make_store
from repro_torch.models.registry import specs_for
from repro_torch.models.small import (
    head_grad_mask, params_from_numpy, small_model_apply,
    small_model_apply_lanes,
)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import Layout, ravel_params, unravel


def fleet_views(arena: np.ndarray, layout: Layout) -> Dict[str, np.ndarray]:
    """``{leaf name: (K, *shape)}`` numpy views of a host ``(K, P)``
    arena (the reference's stacked-params fleet, without a copy)."""
    return {k: v.numpy() for k, v in
            unravel(torch.from_numpy(arena), layout).items()}


@dataclasses.dataclass
class PersonalizeReport:
    """The stage's outputs: the host ``(K, P)`` personalized arena (in
    ``layout``) and the like-for-like per-client accuracy of the fleet and
    of the global model it started from."""
    arena: np.ndarray                   # host (K, P) personalized models
    layout: Layout
    per_client_accuracy: np.ndarray     # (K,) personalized models
    global_accuracy: np.ndarray         # (K,) the global model, same draws
    dispatches: int = 0                 # train calls (one a block)
    seconds: float = 0.0                # stage wall, fenced by the readbacks

    @property
    def fleet(self) -> Dict[str, np.ndarray]:
        return fleet_views(self.arena, self.layout)

    @property
    def personalized_accuracy(self) -> float:
        return float(self.per_client_accuracy.mean())

    @property
    def global_client_accuracy(self) -> float:
        return float(self.global_accuracy.mean())


def per_client_test_sets(
    clients, test, n: int, num_classes: int, rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Label-matched test draws: client k gets ``n`` samples drawn from the
    global test pool with class probabilities proportional to its own
    shard's label histogram (classes absent from the pool renormalize
    away; an empty shard draws uniformly). Returns ``(K, n, ...)`` images
    and ``(K, n)`` labels."""
    by_class = [np.flatnonzero(test.labels == c) for c in range(num_classes)]
    avail = np.asarray([len(b) > 0 for b in by_class], np.float64)
    images = np.empty((len(clients), n) + test.images.shape[1:],
                      test.images.dtype)
    labels = np.empty((len(clients), n), test.labels.dtype)
    for k, client in enumerate(clients):
        hist = np.bincount(client.labels, minlength=num_classes)
        p = hist * avail
        if p.sum() == 0:
            p = avail
        p = p / p.sum()
        cls = rng.choice(num_classes, size=n, p=p)
        idx = np.asarray([by_class[c][rng.integers(len(by_class[c]))]
                          for c in cls])
        images[k] = test.images[idx]
        labels[k] = test.labels[idx]
    return images, labels


def lanes_accuracy(stack: torch.Tensor, images: torch.Tensor,
                   labels: torch.Tensor, layout: Layout,
                   cfg: ModelConfig) -> torch.Tensor:
    """(V,) accuracy of each lane of the (V, P) stack on its own (V, n, ...)
    draws: one lane-stacked forward."""
    logits = small_model_apply_lanes(unravel(stack, layout), images, cfg)
    return torch.mean((torch.argmax(logits, -1) == labels).float(), -1)


def shared_accuracy(w: torch.Tensor, images: torch.Tensor,
                    labels: torch.Tensor, layout: Layout,
                    cfg: ModelConfig) -> torch.Tensor:
    """(V,) accuracy of the one (P,) model on each lane's (V, n, ...)
    draws: one forward over all V*n images."""
    V, n = labels.shape
    logits = small_model_apply(unravel(w, layout),
                               images.reshape(V * n, *images.shape[2:]),
                               cfg).reshape(V, n, -1)
    return torch.mean((torch.argmax(logits, -1) == labels).float(), -1)


def _blocks(total: int, size: int) -> List[np.ndarray]:
    return [np.arange(s, min(s + size, total))
            for s in range(0, total, size)]


def _flat_model(w: Union[torch.Tensor, Mapping], device) -> torch.Tensor:
    """The global model as a flat (P,) tensor on ``device``, from a flat
    tensor or a parameter dict (numpy arrays or tensors)."""
    if isinstance(w, torch.Tensor):
        return w.to(device).reshape(-1)
    return ravel_params(params_from_numpy(
        {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
         for k, v in w.items()}, device))


@torch.no_grad()
def personalize_fleet(model_cfg: ModelConfig, fl: FLConfig, clients,
                      w_glob: Union[torch.Tensor, Mapping], test, *,
                      store=None, device=None) -> PersonalizeReport:
    """Fine-tune every client from ``w_glob`` (a flat (P,) model or a
    parameter dict) and score the fleet, on ``device`` (the GPU unless the
    caller asks for another).

    ``store`` reuses the experiment engine's ``ClientStore`` when it has
    one (the fused engine; under ``mesh_data_axis`` its planes are
    mesh-padded, which the gathers do not see); otherwise a store of the
    configured residency, without a mesh as in the reference, is built
    and closed here. A block is one train call plus two
    forwards. ``block`` defaults to the whole fleet under
    ``store="device"`` and to cohorts of 64 under the staged stores."""
    pcfg = fl.personalize
    if not pcfg.active:
        raise ValueError("personalize_fleet called with an inactive "
                         "PersonalizeConfig (epochs=0)")
    device = resolve_device(device)
    k = len(clients)
    block = pcfg.block or (k if fl.store == "device" else min(k, 64))
    batch_size = pcfg.batch_size or fl.batch_size
    specs = specs_for(model_cfg)
    layout = tuple((name, specs[name].shape) for name in sorted(specs))
    w = _flat_model(w_glob, device)
    mask = (head_grad_mask(unravel(w, layout), model_cfg)
            if pcfg.mode == "head" else None)
    trainer = LocalTrainer(model_cfg, fl, device, grad_mask=mask)
    own_store = store is None
    if own_store:
        store = make_store(fl.store, clients, device)
    rng_plan = np.random.default_rng((pcfg.seed, 1))
    rng_eval = np.random.default_rng((pcfg.seed, 2))

    t0 = time.perf_counter()
    arena = host_stack(w, k)
    acc_p = np.zeros(k, np.float64)
    acc_g = np.zeros(k, np.float64)
    blocks = _blocks(k, block)
    try:
        for bi, ids in enumerate(blocks):
            # one (S, B) plan a client, drawn in fleet-id order
            plans = [plan_epoch_indices(clients[i], batch_size, pcfg.epochs,
                                        rng_plan) for i in ids]
            rows, idx, valid = stack_plan_indices(plans, ids)
            plane = store.arena(ids)
            # one hop: a block of fine-tunes is a star cohort visit
            # without a reduce, and the trained (V, P) stack is the result
            stack = trainer.train_many_fused(
                w, plane, rows[None], idx[None], valid[None], lr=pcfg.lr)
            # the next block's cohort goes to the staging thread while
            # this block's steps run
            if bi + 1 < len(blocks):
                store.prefetch(blocks[bi + 1])
            imgs, labs = per_client_test_sets(
                [clients[i] for i in ids], test, pcfg.eval_per_client,
                model_cfg.num_classes, rng_eval)
            imgs = torch.from_numpy(imgs).to(device)
            labs = torch.from_numpy(labs).to(device)
            acc_p[ids] = lanes_accuracy(stack, imgs, labs, layout,
                                        model_cfg).cpu().numpy()
            acc_g[ids] = shared_accuracy(w, imgs, labs, layout,
                                         model_cfg).cpu().numpy()
            # the block's readback: the host arena owns the trained rows
            arena = unstage_rows(arena, ids, stack)
    finally:
        if own_store:
            store.close()
    return PersonalizeReport(
        arena=arena, layout=layout, per_client_accuracy=acc_p,
        global_accuracy=acc_g, dispatches=trainer.dispatches,
        seconds=time.perf_counter() - t0)


def save_personalized(ckdir: str, arena: np.ndarray, layout: Layout) -> None:
    """Persist a host ``(K, P)`` personalized arena as
    ``<ckdir>/personalized.msgpack``, in the ``{client_id: tree}`` layout
    of ``algo_state.msgpack``."""
    from repro_torch.core.executor import _pack_state

    seen = np.ones(len(arena) + 1, bool)        # every row is live
    save(f"{ckdir}/personalized.msgpack",
         _pack_state(pack_client_rows(arena, seen, layout)))


def restore_personalized(ckdir: str, layout: Layout,
                         num_clients: int) -> Optional[np.ndarray]:
    """The host ``(K, P)`` personalized arena from
    ``<ckdir>/personalized.msgpack`` (None when there is none)."""
    from repro_torch.core.executor import _unpack_state

    path = f"{ckdir}/personalized.msgpack"
    if not os.path.exists(path):
        return None
    arena, _ = unpack_client_rows(_unpack_state(restore(path)), layout,
                                  num_clients, device=False)
    return arena
