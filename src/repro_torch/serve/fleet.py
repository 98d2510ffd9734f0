"""Fleet serving: many clients' models behind one call a step (the port's
twin of the JAX package's ``serve/fleet.py``).

The personalization stage (``core.personalize``) ends with a ``(K, P)``
arena of flat models, one row a client. Serving it with a Python loop
over models costs one call per distinct client in a batch; here a batch
is one call a step whatever it spans:

* **routing** — each request carries a lane (its client id). A classifier
  batch's rows are gathered from the fleet stack with one
  ``index_select`` and run as a lane-stacked forward with one image a
  lane. An LM batch runs ``models.transformer.decode_step_lanes``, which
  gathers each layer's rows just before the layer runs, so prefill is one
  call and each decoded token one call for the whole batch;
* **residency** — ``FleetParams`` keeps the stack on the device, or in a
  host numpy arena for fleets larger than device memory. A host-resident
  batch uploads only its distinct clients' rows as a ``(V, P)`` cohort
  (lanes remap to cohort rows), and ``prefetch`` stages the next batch's
  cohort on a one-worker staging thread while the current batch runs.
  The staging is the client stores' ``data.store.Stager``: on the GPU a
  cohort is gathered into page-locked host memory and copied on a side
  stream, an event fences the copy, the current stream waits on it, and
  the cohort is marked as used by the current stream (``record_stream``),
  so the caching allocator cannot hand its memory to the next copy while
  the batch's kernels still read it. The cohort has no dump row. A
  failure of the staging thread is raised by ``rows``.

Two consumers: ``FleetDecoder``/``fleet_prefill_and_decode`` serve LM
fleets, ``FleetClassifier`` the paper's personalized MLP/CNN fleets. The
per-model loops (``loop_prefill_and_decode``, ``loop_classify``) are the
parity and timing baselines.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.store import Stager
from repro_torch.launch.serve import (
    check_token_inputs, fence, next_tokens, prefill_and_decode,
)
from repro_torch.models.small import small_model_apply, small_model_apply_lanes
from repro_torch.models.transformer import (
    check_lanes, decode_step_lanes, init_cache,
)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import Layout, flatten_tree, nest_tree, unravel


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class FleetParams:
    """A fleet of K models (one flat ``(K, P)`` stack in ``layout``, the
    sorted-leaf order) with a residency policy.

    ``stacked`` is the reference's stacked-params fleet, ``{leaf name:
    (K, *shape)}`` (numpy arrays or tensors), or a nested LM tree of such
    leaves, laid out under ``/``-joined names (``blocks/pos0/attn/wq``);
    ``model`` and ``tree`` hand an LM fleet's models back nested.
    ``from_arena`` takes a flat ``(K, P)`` arena and its layout without a
    copy (a CUDA tensor stays where it is). The reference's
    ``device: bool`` flag is ``resident`` here (``device=`` is the torch
    device, the GPU unless the caller asks for another): ``resident=True``
    keeps the stack on the device, where lane ids are stack rows and
    ``rows`` is free; ``resident=False`` keeps a host numpy arena and
    stages each batch's cohort (see the module docstring).
    ``stage_seconds`` adds up the staging wall, ``overlapped_stage_seconds``
    the part of it a ``prefetch`` ran ahead of its batch."""

    def __init__(self, stacked: Mapping, resident: bool = True, *,
                 device=None):
        stacked = flatten_tree(stacked)
        if not stacked:
            raise ValueError("FleetParams needs a non-empty params dict")
        names = sorted(stacked)
        leaves = [_numpy(stacked[k]) for k in names]
        k = leaves[0].shape[0]
        if any(v.shape[0] != k for v in leaves):
            raise ValueError("every leaf of a fleet needs the same K rows")
        layout = tuple((n, tuple(v.shape[1:])) for n, v in zip(names, leaves))
        arena = np.concatenate(
            [v.reshape(k, -1).astype(np.float32, copy=False) for v in leaves],
            axis=1)
        self._setup(arena, layout, resident, device)

    @classmethod
    def from_arena(cls, arena, layout: Layout, resident: bool = True, *,
                   device=None) -> "FleetParams":
        """A fleet over a flat ``(K, P)`` arena (a numpy array, e.g. the
        personalization stage's, or a tensor) in ``layout``, without a
        copy where the residency allows one."""
        self = cls.__new__(cls)
        self._setup(arena, tuple(layout), resident, device)
        return self

    @classmethod
    def from_trees(cls, trees: Sequence[Mapping], resident: bool = True, *,
                   device=None) -> "FleetParams":
        """Stack a list of per-client parameter dicts (flat or nested) into
        a fleet."""
        if not trees:
            raise ValueError("FleetParams needs at least one model")
        flat = [flatten_tree(t) for t in trees]
        return cls({k: np.stack([_numpy(t[k]) for t in flat])
                    for k in flat[0]}, resident, device=device)

    def _setup(self, arena, layout: Layout, resident: bool, device) -> None:
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.layout = layout
        self.nested = any("/" in name for name, _ in layout)
        self.resident = resident
        width = sum(int(np.prod(s)) for _, s in layout)
        if arena.ndim != 2 or arena.shape[1] != width or len(arena) == 0:
            raise ValueError(f"a fleet arena is (K, {width}) for this layout, "
                             f"not {tuple(arena.shape)}")
        self.num_clients = int(arena.shape[0])
        self.stage_seconds = 0.0
        self.overlapped_stage_seconds = 0.0
        if resident:
            self._stack = torch.as_tensor(arena, dtype=torch.float32).to(
                self.device)
            self._arena = None
        else:
            self._stack = None
            self._arena = np.ascontiguousarray(_numpy(arena), np.float32)
        # the staged cohort, (key, stack)
        self._cohort: Optional[Tuple[tuple, torch.Tensor]] = None
        self._stager = (None if resident else
                        Stager(self.device, self._gather, lambda s: (s,),
                               "repro-torch-fleet"))

    def model(self, lane: int) -> Dict[str, torch.Tensor]:
        """One client's parameter dict on the device (the loop baseline's
        model), nested for an LM fleet."""
        if self.resident:
            row = self._stack[int(lane)]
        else:
            row = torch.from_numpy(self._arena[int(lane)]).to(self.device)
        return self.tree(row)

    def tree(self, stack: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-leaf views of a ``(..., P)`` stack in this fleet's layout,
        nested for an LM fleet."""
        flat = unravel(stack, self.layout)
        return nest_tree(flat) if self.nested else flat

    @staticmethod
    def _ids(lanes) -> np.ndarray:
        return np.unique(np.asarray(lanes, np.int64))

    def _gather(self, ids: np.ndarray, pinned: bool) -> torch.Tensor:
        """Gather and upload the cohort rows ``ids`` (the stager's build).
        torch's gather runs on the host's threads; np.take with out=
        buffers the copy and ran several times slower."""
        src, idx = torch.from_numpy(self._arena), torch.from_numpy(ids)
        if not pinned:
            return torch.index_select(src, 0, idx).to(self.device)
        host = torch.empty((len(ids), self._arena.shape[1]),
                           dtype=torch.float32, pin_memory=True)
        torch.index_select(src, 0, idx, out=host)
        return host.to(self.device, non_blocking=True)

    def prefetch(self, lanes) -> None:
        """Start staging the cohort of a later ``rows(lanes)`` call on the
        staging thread (nothing to do for a resident fleet)."""
        if self.resident:
            return
        ids = self._ids(lanes)
        key = tuple(ids.tolist())
        if self._cohort is None or self._cohort[0] != key:
            self._stager.prefetch(key, ids)

    def rows(self, lanes) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device stack serving this batch and the batch's lanes
        remapped into it: ``(stack, local)`` with request ``b``'s model in
        row ``local[b]`` of ``stack``."""
        lanes = np.asarray(lanes, np.int64)
        if self.resident:
            if lanes.size and (lanes.min() < 0
                               or lanes.max() >= self.num_clients):
                raise IndexError(f"lanes outside the fleet's "
                                 f"{self.num_clients} clients")
            return self._stack, torch.from_numpy(lanes).to(self.device)
        ids = self._ids(lanes)
        key = tuple(ids.tolist())
        if self._cohort is None or self._cohort[0] != key:
            if not self._stager.pending(key):
                self._cohort = None     # free the old cohort before staging
            stack, secs, prefetched = self._stager.take(key, ids)
            self.stage_seconds += secs
            if prefetched:
                self.overlapped_stage_seconds += secs
            self._cohort = (key, stack)
        local = np.searchsorted(ids, lanes)
        return self._cohort[1], torch.from_numpy(local).to(self.device)

    def close(self) -> None:
        """Drain a prefetch in flight and stop the staging thread."""
        if self._stager is not None:
            self._stager.close()


def _images(images, device: torch.device) -> torch.Tensor:
    """A request batch's images as float32 on the fleet's device."""
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.asarray(images, np.float32))
    return images.to(device=device, dtype=torch.float32)


class FleetClassifier:
    """Personalized classification of a request batch in one forward: one
    gather of the batch's rows from the fleet stack, then one lane-stacked
    forward with each request a lane of one image. Returns the
    ``(B, num_classes)`` logits on the fleet's device; each call counts one
    dispatch."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.dispatches = 0

    @torch.no_grad()
    def __call__(self, fleet: FleetParams, lanes, images) -> torch.Tensor:
        stack, local = fleet.rows(lanes)
        params = unravel(torch.index_select(stack, 0, local), fleet.layout)
        x = _images(images, fleet.device)
        self.dispatches += 1
        return small_model_apply_lanes(params, x.unsqueeze(1), self.cfg)[:, 0]


@torch.no_grad()
def loop_classify(cfg: ModelConfig, fleet: FleetParams, lanes,
                  images) -> torch.Tensor:
    """The per-model baseline: for each distinct client of the batch, take
    its model from the fleet and run one forward over its requests.
    Returns the ``(B, num_classes)`` logits on the fleet's device."""
    lanes = np.asarray(lanes, np.int64)
    x = _images(images, fleet.device)
    out = torch.empty((len(lanes), cfg.num_classes), dtype=torch.float32,
                      device=fleet.device)
    for lane in np.unique(lanes):
        sel = torch.from_numpy(np.flatnonzero(lanes == lane)).to(fleet.device)
        out[sel] = small_model_apply(fleet.model(int(lane)),
                                     torch.index_select(x, 0, sel), cfg)
    return out


# ---------------------------------------------------------------------------
# LM fleets: prefill and per-token decode, one call a step


def _tokens(x, device: torch.device) -> torch.Tensor:
    """Token ids as an int32 tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.int32))
    return x.to(device=device, dtype=torch.int32)


class FleetDecoder:
    """Fleet decode steps for one ``ModelConfig``: every request of a batch
    decodes under its own model (``decode_step_lanes``) with its own cache
    row, and the whole batch is one call a token. ``prefill`` is one call
    too: like ``launch/serve.py``'s, it feeds the prompt through the decode
    step one position at a time. ``dispatches`` counts calls, as the
    reference's counts compiled calls; ``gathered_bytes`` is the rows the
    last call's steps gathered, a step on average. An embeds model raises
    ``ValueError``: its loop feeds tokens back (``check_token_inputs``)."""

    def __init__(self, cfg: ModelConfig):
        check_lanes(cfg)            # moe, hybrid raise (A10.4b-fleet)
        check_token_inputs(cfg)
        self.cfg = cfg
        self.dispatches = 0
        self.gathered_bytes = 0

    def new_cache(self, batch: int, max_len: int, dtype=torch.float32,
                  device=None):
        """One cache row a request: ``init_cache(cfg, batch, ...)``."""
        return init_cache(self.cfg, batch, max_len, dtype=dtype,
                          device=device)

    def prefill(self, stack, lanes: torch.Tensor, prompts: torch.Tensor,
                cache):
        """Fill every request's cache with its prompt (B, S0). ``stack`` is
        the fleet's tree of ``(K, ...)`` leaves (``FleetParams.tree``) and
        ``lanes`` the requests' rows in it. Returns (last logits (B, V),
        cache)."""
        self.dispatches += 1
        meter = [0]
        for i in range(prompts.shape[1]):
            logits, cache = decode_step_lanes(stack, lanes, prompts[:, i:i + 1],
                                              cache, i, self.cfg, meter)
        self.gathered_bytes = meter[0] // prompts.shape[1]
        return logits[:, 0], cache

    def decode_step(self, stack, lanes: torch.Tensor, tok: torch.Tensor,
                    cache, pos: int):
        """Decode ``tok`` (B,) at position ``pos``: (logits (B, V), cache)."""
        self.dispatches += 1
        meter = [0]
        logits, cache = decode_step_lanes(stack, lanes, tok[:, None], cache,
                                          pos, self.cfg, meter)
        self.gathered_bytes = meter[0]
        return logits[:, 0], cache


@torch.no_grad()
def fleet_prefill_and_decode(
    cfg: ModelConfig,
    fleet: FleetParams,
    lanes,                        # (B,) int client ids: request routing
    prompts,                      # (B, S0) int32
    *,
    max_len: int,
    new_tokens: int,
    temperature: float = 0.0,
    seed: int = 0,
    decoder: Optional[FleetDecoder] = None,
) -> Tuple[torch.Tensor, dict]:
    """Batched generation across many clients' models: one prefill call,
    then one call a decoded token for the whole batch, request b under
    client ``lanes[b]``'s model throughout. Returns (tokens (B, S0 + N) on
    the fleet's device, stats). Temperature sampling draws from a
    ``torch.Generator`` seeded with ``seed`` on that device; every clock
    read is fenced by a device synchronize."""
    device = fleet.device
    prompts = _tokens(prompts, device)
    b, s0 = prompts.shape
    decoder = FleetDecoder(cfg) if decoder is None else decoder
    stack, local = fleet.rows(lanes)
    tree = fleet.tree(stack)
    cache = decoder.new_cache(b, max_len, device=device)
    gen = (torch.Generator(device=device).manual_seed(seed)
           if temperature > 0 else None)

    t0 = fence(device)
    d0 = decoder.dispatches
    last_logits, cache = decoder.prefill(tree, local, prompts, cache)
    t1 = fence(device)
    prefill_dispatches = decoder.dispatches - d0

    d0 = decoder.dispatches
    new = []
    for i in range(new_tokens):
        nxt = next_tokens(last_logits, temperature, gen)
        new.append(nxt)
        last_logits, cache = decoder.decode_step(tree, local, nxt, cache,
                                                 s0 + i)
    toks = torch.cat([prompts] + [n[:, None] for n in new], dim=1)
    t2 = fence(device)
    decode_s = t2 - t1
    return toks, {
        "prefill_s": t1 - t0,
        "decode_s": decode_s,
        "decode_tok_s": b * new_tokens / max(decode_s, 1e-9),
        "requests_s": b / max(t2 - t0, 1e-9),
        "prefill_dispatches": prefill_dispatches,
        "decode_dispatches_per_step": (decoder.dispatches - d0)
        / max(new_tokens, 1),
        "distinct_models": int(len(np.unique(np.asarray(lanes)))),
    }


@torch.no_grad()
def loop_prefill_and_decode(
    cfg: ModelConfig,
    fleet: FleetParams,
    lanes,
    prompts,
    *,
    max_len: int,
    new_tokens: int,
) -> Tuple[torch.Tensor, dict]:
    """The per-model baseline (greedy only): group the requests by client
    and run ``launch/serve.py::prefill_and_decode`` once per distinct
    model. Returns (tokens (B, S0 + N) on the fleet's device, stats)."""
    device = fleet.device
    lanes = np.asarray(lanes, np.int64)
    prompts = _tokens(prompts, device)
    out = torch.empty((len(lanes), prompts.shape[1] + new_tokens),
                      dtype=torch.int32, device=device)
    t0 = fence(device)
    models = 0
    for lane in np.unique(lanes):
        sel = torch.from_numpy(np.flatnonzero(lanes == lane)).to(device)
        out[sel], _ = prefill_and_decode(
            cfg, fleet.model(int(lane)), torch.index_select(prompts, 0, sel),
            max_len=max_len, new_tokens=new_tokens)
        models += 1
    t1 = fence(device)
    return out, {
        "total_s": t1 - t0,
        "requests_s": len(lanes) / max(t1 - t0, 1e-9),
        "distinct_models": models,
    }
