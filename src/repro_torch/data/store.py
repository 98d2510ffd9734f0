"""Client stores — where the fleet's shards live between rounds (the port's
twin of the JAX package's ``data/store.py``; ``FLConfig.store``).

* ``DeviceStore`` — the whole fleet uploads once as one
  ``DeviceDataPlane`` and every block reuses it.
* ``HostStore`` — shards stay in host RAM (the ``ClientData`` arrays are
  the store); at each block boundary the fused engine asks for the
  block's cohort arena: a ``DeviceDataPlane`` over only the visited
  clients, its fleet-sized ``offsets`` table folding in the fleet→cohort
  row remap. Plans, index stacks and the block's gather are those of the
  device store, so the two are bit-exact while peak device bytes scale
  with the cohort, not K. The previous block's arena is dropped when the
  next one is staged.
* ``StreamStore`` — the fleet's pixels live in disk-backed ``np.memmap``
  shards, written once at construction into a temp dir the store owns; a
  block's cohort is gathered from the memmap slices into its arena, so
  host RAM holds O(cohort) too. Its arenas are byte-identical to the host
  store's.

A block's visited set comes from its pre-drawn plans
(``Schedule.visited``), so staging never needs a device readback.

With ``mesh`` (the fused engine under ``FLConfig.mesh_data_axis``) every
plane a store builds, the fleet's or a cohort's, takes
``DeviceDataPlane``'s mesh layout: shards padded to the plane's largest,
rows to a mesh multiple.

**Prefetch** (``FLConfig.prefetch=1``): ``prefetch(visited)`` hands the
next block's gather and upload to a one-worker background thread while
the current block runs; ``arena(visited)`` consumes a matching prefetch
instead of staging synchronously. During the hand-over both arenas are
live (a double buffer), so peak residency is at most two cohorts;
``last_pair_nbytes`` reports that pair. ``stage_seconds`` and
``overlapped_stage_seconds`` add up the staging wall and the part of it a
prefetch hid.

**On the GPU** a staged arena is gathered into page-locked host buffers
and copied with ``non_blocking=True`` on a side CUDA stream that the
store's ``Stager`` owns (the serving fleet's host-resident cohorts stage
through the same class); the build records an event there and waits for
it, so ``stage_seconds`` covers the copy. The consumer (``arena``) makes the
current stream wait on that event, and marks each arena tensor as used by
the current stream (``record_stream``): the tensors were allocated on the
side stream, and without the mark the caching allocator could hand a
dropped arena's memory to the next prefetch's copy while kernels on the
current stream still read it. The worker thread sets the device itself.
On the CPU the same code runs without streams or events.
"""
from __future__ import annotations

import concurrent.futures
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import ClientData, DeviceDataPlane
from repro_torch.utils.logging import timed


class ClientStore:
    """Residency policy for client shards. ``arena(visited)`` returns the
    ``DeviceDataPlane`` serving a block that visits the given fleet ids
    (``None``: possibly all of them); ``arena_nbytes(visited)`` is the H2D
    cost of that call (0 when the arena is already resident);
    ``prefetch(visited)`` starts staging the next block's arena in the
    background (a no-op for stores with nothing to stage)."""

    kind = ""

    def __init__(self, clients: Sequence[ClientData], device: torch.device,
                 mesh=None):
        self.clients = list(clients)
        self.mesh = mesh
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.stage_seconds = 0.0            # total staging wall
        self.overlapped_stage_seconds = 0.0  # staging wall hidden by prefetch
        self.last_pair_nbytes = 0           # arenas live at the last swap

    def arena(self, visited: Optional[np.ndarray] = None) -> DeviceDataPlane:
        raise NotImplementedError

    def arena_nbytes(self, visited: Optional[np.ndarray] = None) -> int:
        raise NotImplementedError

    def prefetch(self, visited: Optional[np.ndarray] = None) -> None:
        """Start staging the arena for ``visited`` in the background; the
        matching ``arena(visited)`` call consumes it. Only the stores that
        stage per block have anything to overlap."""

    def close(self) -> None:
        """Release background resources (the staging thread, disk shards).
        Safe to call twice, and on a store that never staged."""


class DeviceStore(ClientStore):
    """Upload the whole fleet once; every block reuses the same plane."""

    kind = "device"

    def __init__(self, clients, device, mesh=None):
        super().__init__(clients, device, mesh=mesh)
        self._plane: Optional[DeviceDataPlane] = None

    def arena(self, visited=None) -> DeviceDataPlane:
        if self._plane is None:
            with timed(lambda s: setattr(
                    self, "stage_seconds", self.stage_seconds + s)):
                self._plane = DeviceDataPlane(self.clients, self.device,
                                              mesh=self.mesh)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            self.last_pair_nbytes = self._plane.nbytes
        return self._plane

    def arena_nbytes(self, visited=None) -> int:
        first = self._plane is None
        return self.arena(visited).nbytes if first else 0


class Stager:
    """Background staging with at most one prefetch in flight, shared by the
    staged client stores and the host-resident serving fleet
    (``serve.fleet.FleetParams``), which differ only in what they gather.

    ``build(ids, pinned)`` gathers and uploads the buffers for ``ids``
    (into page-locked host memory, copied with ``non_blocking=True``, when
    ``pinned``); ``tensors(built)`` lists the device tensors of what it
    returned. On the GPU the build runs on a side stream this stager owns
    and is fenced by an event before its clock stops; ``take`` hands it
    over to the current stream (see the module docstring). A prefetch is
    keyed by ``key``: ``take`` consumes a matching one, drains a stale
    one and builds synchronously instead; a failure of the staging thread
    is raised there."""

    def __init__(self, device: torch.device, build, tensors,
                 name: str = "repro-torch-stage"):
        self.device = device
        self._build_fn = build
        self._tensors = tensors
        self._name = name
        # at most one prefetch in flight: (key, future)
        self._pending: Optional[Tuple[tuple, concurrent.futures.Future]] = None
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._stream = (torch.cuda.Stream(device)
                        if device.type == "cuda" else None)

    def _build(self, ids: np.ndarray):
        """Build for ``ids``: ``(built, event, seconds)``. Runs on the
        staging thread under a prefetch."""
        secs = [0.0]
        event = None
        with timed(lambda s: secs.__setitem__(0, s)):
            if self._stream is None:
                built = self._build_fn(ids, False)
            else:
                # the staging thread sets its device itself
                with torch.cuda.device(self.device), \
                        torch.cuda.stream(self._stream):
                    built = self._build_fn(ids, True)
                    event = torch.cuda.Event()
                    event.record(self._stream)
                event.synchronize()
        return built, event, secs[0]

    def _hand_over(self, built, event) -> None:
        """Make buffers built on the side stream safe to read on the
        current stream: wait for their copy, and tie their memory to the
        current stream's work so the allocator cannot reuse it under that
        work once they are dropped."""
        if event is None:
            return
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for t in self._tensors(built):
            t.record_stream(current)

    def pending(self, key: tuple) -> bool:
        """Whether a prefetch for ``key`` is in flight."""
        return self._pending is not None and self._pending[0] == key

    def prefetch(self, key: tuple, ids: np.ndarray) -> None:
        """Start building for ``ids`` on the staging thread."""
        if self.pending(key):
            return
        if self._pending is not None:       # a superseded prefetch: drain it
            pending, self._pending = self._pending, None
            pending[1].result()
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=self._name)
        self._pending = (key, self._pool.submit(self._build, ids))

    def take(self, key: tuple, ids: np.ndarray):
        """The buffers for ``ids``, handed over to the current stream:
        ``(built, seconds, prefetched)``. A caller frees what it replaces
        before a synchronous build (``pending(key)`` false)."""
        hit = self.pending(key)
        pending, self._pending = self._pending, None
        if hit:
            built, event, secs = pending[1].result()
        else:
            if pending is not None:         # a stale prefetch for another set
                pending[1].result()
            built, event, secs = self._build(ids)
        self._hand_over(built, event)
        return built, secs, hit

    def close(self) -> None:
        """Drain a prefetch in flight and stop the staging thread. Safe to
        call twice."""
        pending, self._pending = self._pending, None
        try:
            if pending is not None:
                pending[1].result()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None


class _StagedStore(ClientStore):
    """Per-block cohort staging shared by the host and stream stores, which
    differ only in where ``_cohort`` reads the pixels from."""

    def __init__(self, clients, device, mesh=None):
        super().__init__(clients, device, mesh=mesh)
        self._arena: Optional[DeviceDataPlane] = None
        self._visited: Optional[tuple] = None
        self._stager = Stager(self.device, self._gather,
                              DeviceDataPlane.tensors)

    def _cohort(self, visited: np.ndarray) -> List[ClientData]:
        """The visited clients' shards, wherever this store keeps them."""
        raise NotImplementedError

    def _gather(self, visited: np.ndarray, pinned: bool) -> DeviceDataPlane:
        """Gather and upload one cohort arena (the stager's build)."""
        return DeviceDataPlane(self._cohort(visited), self.device,
                               client_ids=visited,
                               fleet_size=len(self.clients), pinned=pinned,
                               mesh=self.mesh)

    @staticmethod
    def _key(visited: np.ndarray) -> tuple:
        return tuple(visited.tolist())

    def _as_ids(self, visited) -> np.ndarray:
        if visited is None:
            visited = np.arange(len(self.clients))
        return np.asarray(visited, np.int64)

    def prefetch(self, visited=None) -> None:
        visited = self._as_ids(visited)
        key = self._key(visited)
        if key != self._visited:            # else already resident
            self._stager.prefetch(key, visited)

    def arena(self, visited=None) -> DeviceDataPlane:
        visited = self._as_ids(visited)
        key = self._key(visited)
        if self._visited == key:
            return self._arena
        if not self._stager.pending(key):
            self._arena = None      # free the previous cohort before staging
        plane, secs, prefetched = self._stager.take(key, visited)
        self.stage_seconds += secs
        if prefetched:
            # built while the previous block ran, so its whole wall counts
            # as overlapped; both arenas are live until the swap below
            # (the double buffer's high-water mark)
            self.overlapped_stage_seconds += secs
            prev = self._arena.nbytes if self._arena is not None else 0
            self.last_pair_nbytes = prev + plane.nbytes
        else:
            self.last_pair_nbytes = plane.nbytes
        self._arena = plane
        self._visited = key
        return self._arena

    def arena_nbytes(self, visited=None) -> int:
        staged = self._visited
        plane = self.arena(visited)
        return plane.nbytes if self._visited != staged else 0

    def close(self) -> None:
        self._stager.close()


class HostStore(_StagedStore):
    """Host-resident fleet; per block, upload only the visited cohort."""

    kind = "host"

    def _cohort(self, visited):
        return [self.clients[int(i)] for i in visited]


class StreamStore(_StagedStore):
    """Disk-backed fleet: the pixels live in ``np.memmap`` shards; per
    block, only the visited cohort is read from disk and uploaded. The
    memmaps are written once at construction into a temp dir that lives
    as long as the store (``close`` removes it), and every cohort arena is
    byte-identical to the host store's."""

    kind = "stream"

    def __init__(self, clients, device, mesh=None):
        super().__init__(clients, device, mesh=mesh)
        self._tmp = tempfile.TemporaryDirectory(prefix="repro_torch_stream_")
        c0 = clients[0]
        sizes = np.asarray([len(c) for c in clients], np.int64)
        total = int(sizes.sum())
        self._starts = np.concatenate([[0], np.cumsum(sizes)])
        img_path = f"{self._tmp.name}/images.dat"
        lab_path = f"{self._tmp.name}/labels.dat"
        img_shape = (total,) + c0.images.shape[1:]
        imgs = np.memmap(img_path, dtype=c0.images.dtype, mode="w+",
                         shape=img_shape)
        labs = np.memmap(lab_path, dtype=c0.labels.dtype, mode="w+",
                         shape=(total,))
        for i, c in enumerate(clients):
            s, e = self._starts[i], self._starts[i + 1]
            imgs[s:e] = c.images
            labs[s:e] = c.labels
        imgs.flush()
        labs.flush()
        del imgs, labs
        # reopened read-only: the store serves gathers and never writes
        self._images = np.memmap(img_path, dtype=c0.images.dtype, mode="r",
                                 shape=img_shape)
        self._labels = np.memmap(lab_path, dtype=c0.labels.dtype, mode="r",
                                 shape=(total,))
        # the fleet's RAM shards are not kept: only ids and lengths, so
        # host residency scales with the cohort, not K
        self.clients = [_ShardRef(c.client_id, len(c)) for c in clients]

    def _cohort(self, visited):
        out = []
        for i in visited:
            s, e = self._starts[int(i)], self._starts[int(i) + 1]
            # the cohort's slices read from disk into RAM
            out.append(ClientData(int(i), np.asarray(self._images[s:e]),
                                  np.asarray(self._labels[s:e])))
        return out

    def close(self) -> None:
        super().close()
        if self._tmp is not None:
            self._images = self._labels = None
            self._tmp.cleanup()
            self._tmp = None


class _ShardRef:
    """Length-only stand-in for a shard whose pixels live on disk
    (``StreamStore``): enough for fleet-size and weight bookkeeping
    without keeping K shards in RAM."""

    __slots__ = ("client_id", "_len")

    def __init__(self, client_id: int, n: int):
        self.client_id = client_id
        self._len = n

    def __len__(self) -> int:
        return self._len


STORES = {"device": DeviceStore, "host": HostStore, "stream": StreamStore}


def make_store(name: str, clients: List[ClientData], device: torch.device,
               mesh=None) -> ClientStore:
    """Build the residency policy selected by ``FLConfig.store``; with
    ``mesh`` every plane it builds takes the mesh layout
    (``DeviceDataPlane``)."""
    if name not in STORES:
        raise ValueError(f"unknown FLConfig.store {name!r}; "
                         "expected 'device', 'host' or 'stream'")
    return STORES[name](clients, device, mesh=mesh)
