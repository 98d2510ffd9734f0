"""Classifier fleet serving: many clients' models, one forward a request
batch (the port's twin of the JAX package's ``serve/fleet.py``, its
``FleetParams``, ``FleetClassifier`` and ``loop_classify``).

The personalization stage (``core.personalize``) ends with a ``(K, P)``
arena of flat models, one row a client. Serving it with a Python loop
over models costs one forward per distinct client in a batch; here a
batch is one forward whatever it spans:

* **routing** — each request carries a lane (its client id); the batch's
  rows are gathered from the fleet stack with one ``index_select`` and run
  as a lane-stacked forward with one image a lane;
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

The reference's ``FleetDecoder``, ``fleet_prefill_and_decode``,
``loop_prefill_and_decode`` and ``launch/serve.py --fleet`` serve LM
fleets; they are not ported yet (ROADMAP A10.2).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.store import Stager
from repro_torch.models.small import small_model_apply, small_model_apply_lanes
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import Layout, unravel


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class FleetParams:
    """A fleet of K flat models (one ``(K, P)`` stack in ``layout``, the
    sorted-leaf order) with a residency policy.

    ``stacked`` is the reference's stacked-params fleet, ``{leaf name:
    (K, *shape)}`` (numpy arrays or tensors); ``from_arena`` takes a flat
    ``(K, P)`` arena and its layout without a copy. The reference's
    ``device: bool`` flag is ``resident`` here (``device=`` is the torch
    device, the GPU unless the caller asks for another): ``resident=True``
    keeps the stack on the device, where lane ids are stack rows and
    ``rows`` is free; ``resident=False`` keeps a host numpy arena and
    stages each batch's cohort (see the module docstring).
    ``stage_seconds`` adds up the staging wall, ``overlapped_stage_seconds``
    the part of it a ``prefetch`` ran ahead of its batch."""

    def __init__(self, stacked: Mapping, resident: bool = True, *,
                 device=None):
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
        """Stack a list of per-client parameter dicts into a fleet."""
        if not trees:
            raise ValueError("FleetParams needs at least one model")
        return cls({k: np.stack([_numpy(t[k]) for t in trees])
                    for k in trees[0]}, resident, device=device)

    def _setup(self, arena, layout: Layout, resident: bool, device) -> None:
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.layout = layout
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
        model)."""
        if self.resident:
            row = self._stack[int(lane)]
        else:
            row = torch.from_numpy(self._arena[int(lane)]).to(self.device)
        return unravel(row, self.layout)

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
