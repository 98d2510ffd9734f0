"""Per-client data pipeline (the port's twin of the JAX package's
``data/pipeline.py``).

``plan_epoch_indices`` is the one batch-plan primitive: planners pre-draw a
(steps, batch) index plan per client visit and attach it to the RoundPlan
IR. The engines materialize the plans in three ways:

* the sequential engine feeds each plan to ``LocalTrainer.train``, which
  moves one batch a step from the client's numpy shard;
* the batched engine stacks one hop's plans into client-stacked host
  arrays and a valid-step mask (``stack_plans``) that cross H2D per call;
* the fused engine keeps every shard device-resident (``DeviceDataPlane``,
  uploaded once) and ships only the int32 index form of the plans
  (``stack_plan_indices``).

Every function here consumes the numpy generator in the reference's order,
so plans and stacks are bit-identical across the two packages.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.partition import partition
from repro_torch.data.synthetic import Dataset
from repro_torch.launch.mesh import round_up_to_mesh


def plan_epoch_indices(
    client: "ClientData", batch_size: int, epochs: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """(steps, batch_size) sample-index plan for ``epochs`` shuffled epochs.

    Each epoch is a permutation; when the shard does not divide evenly into
    full batches, the final batch is topped up by resampling uniform random
    indices (``rng.integers``) — an extra draw on the shared stream, made in
    the same place as in the reference.
    """
    n = len(client)
    num_batches = max(1, int(np.ceil(n / batch_size)))
    rows = []
    for _ in range(epochs):
        idx = rng.permutation(n)
        if num_batches * batch_size > n:
            extra = rng.integers(0, n, size=num_batches * batch_size - n)
            idx = np.concatenate([idx, extra])
        rows.append(idx.reshape(num_batches, batch_size))
    return np.concatenate(rows, axis=0)


def _plan_batch_width(plans: Sequence[Optional[np.ndarray]],
                      width: Optional[int] = None) -> int:
    """Batch width B shared by every real plan in a stack (``width`` when
    the caller supplies it, since a stack may hold only ``None`` plans)."""
    if width is not None:
        return width
    for p in plans:
        if p is not None:
            return p.shape[1]
    raise ValueError(
        "cannot stack batch plans: every plan is None (at least one client "
        "in the stack must have a real (steps, batch) index plan, or pass "
        "an explicit batch width)")


def stack_plans(
    clients: Sequence["ClientData"],
    plans: Sequence[Optional[np.ndarray]],
    pad_to: Optional[int] = None,
    width: Optional[int] = None,
) -> Tuple[dict, np.ndarray]:
    """Materialize per-client batch plans into client-stacked arrays:
    ``({"images": (C, S, B, ...), "labels": (C, S, B)}, valid)`` with S the
    longest plan and ``valid`` a (C, S) bool mask. A shorter plan is padded
    by repeating its first batch (real data, masked steps); a ``None`` plan
    (a ring tail) becomes an all-invalid row of the client's first sample.
    ``pad_to`` appends ghost rows of zero data, all-invalid; ``width``
    gives the batch width when every plan may be ``None``."""
    B = _plan_batch_width(plans, width)
    real = [p if p is not None else np.zeros((1, B), np.int64) for p in plans]
    S = max(p.shape[0] for p in real)
    imgs, labs = [], []
    valid = np.zeros((len(clients), S), bool)
    for ci, (c, p) in enumerate(zip(clients, real)):
        s = p.shape[0]
        img, lab = c.images[p], c.labels[p]
        if s < S:
            img = np.concatenate([img, np.repeat(img[:1], S - s, axis=0)])
            lab = np.concatenate([lab, np.repeat(lab[:1], S - s, axis=0)])
        imgs.append(img)
        labs.append(lab)
        valid[ci, :s] = plans[ci] is not None
    out = {"images": np.stack(imgs), "labels": np.stack(labs)}
    if pad_to is not None and pad_to > len(clients):
        ghosts = pad_to - len(clients)
        out = {k: np.concatenate(
                   [v, np.zeros((ghosts,) + v.shape[1:], v.dtype)])
               for k, v in out.items()}
        valid = np.concatenate([valid, np.zeros((ghosts, S), bool)])
    return out, valid


def stack_client_batches(
    clients: Sequence["ClientData"], batch_size: int, epochs: int,
    rng: np.random.Generator, pad_to: Optional[int] = None,
) -> Tuple[dict, np.ndarray]:
    """Plan and stack one cohort's visits, drawing the plans client by
    client (the sequential engine's visit order)."""
    plans = [plan_epoch_indices(c, batch_size, epochs, rng) for c in clients]
    return stack_plans(clients, plans, pad_to=pad_to)


def stack_plan_indices(
    plans: Sequence[Optional[np.ndarray]],
    client_rows: Sequence[int],
    pad_to: Optional[int] = None,
    steps: Optional[int] = None,
    width: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(rows, idx, valid)`` for one hop: the (C,) int32 fleet row of each
    lane, the (C, S, B) int32 sample-index plan and the (C, S) bool step
    mask. ``None`` plans become all-invalid rows pointing at sample 0;
    ``steps`` forces the step axis to at least S; ``pad_to`` appends ghost
    rows (row 0, all-invalid)."""
    B = _plan_batch_width(plans, width)
    S = max((p.shape[0] for p in plans if p is not None), default=0)
    if steps is not None:
        S = max(S, steps)
    if S == 0:
        raise ValueError("cannot stack an all-None hop without `steps`")
    C = len(plans)
    rows = np.asarray(client_rows, np.int32)
    idx = np.zeros((C, S, B), np.int32)
    valid = np.zeros((C, S), bool)
    for ci, p in enumerate(plans):
        if p is None:
            continue
        idx[ci, : p.shape[0]] = p
        valid[ci, : p.shape[0]] = True
    if pad_to is not None and pad_to > C:
        ghosts = pad_to - C
        rows = np.concatenate([rows, np.zeros(ghosts, np.int32)])
        idx = np.concatenate([idx, np.zeros((ghosts, S, B), np.int32)])
        valid = np.concatenate([valid, np.zeros((ghosts, S), bool)])
    return rows, idx, valid


class DeviceDataPlane:
    """Client shards resident on the device: upload once, gather per step.

    Shards are concatenated along one flat sample axis — ``images``
    ``(total, ...)`` float32, ``labels`` ``(total,)`` int32 — with an int32
    ``offsets`` table giving each client's first row, so client ``r``'s
    sample ``i`` lives at ``offsets[r] + i``. ``nbytes`` is the upload's
    size (labels counted as the int32 they are stored as, like the
    reference's plane).

    ``client_ids`` builds a cohort plane (``data.store``'s host and stream
    stores): only the given fleet ids' shards upload, but ``offsets``
    stays fleet-sized (``fleet_size``), each visited id mapped to its
    cohort-local flat start and every other id to row 0 (real data, only
    ever gathered under an all-invalid mask). The fleet-id ``rows`` of
    ``stack_plan_indices`` and the block's gather are untouched by it. By
    default the plane holds the whole fleet in id order.

    With ``mesh`` (``launch.mesh``) the plane takes the reference's
    mesh layout: every shard zero-padded to the largest one, ``N_max``,
    and the shard count rounded up to a multiple of the mesh's axis
    size, so client ``i`` of the plane starts at ``i * N_max``.
    Gathers read the same samples; ``nbytes`` counts the padded upload,
    and ``real_nbytes`` the unpadded shards and the offsets table (equal
    to ``nbytes`` without a mesh).

    ``pinned`` gathers the shards straight into page-locked host buffers
    and copies them with ``non_blocking=True`` on the current CUDA stream
    (the stores' side stream), so the copy overlaps work on other
    streams; the caller fences it.
    """

    def __init__(self, clients: Sequence["ClientData"],
                 device: torch.device, client_ids=None,
                 fleet_size: Optional[int] = None, pinned: bool = False,
                 mesh=None):
        if not clients:
            raise ValueError("DeviceDataPlane needs at least one client shard")
        self.num_clients = len(clients)
        if client_ids is None:
            client_ids = np.arange(len(clients))
        client_ids = np.asarray(client_ids, np.int64)
        if fleet_size is None:
            fleet_size = len(clients)
        sizes = [len(c) for c in clients]
        c0 = clients[0]
        offs = _host_buffer((fleet_size,), np.int32, pinned)
        offs.zero_()
        if mesh is None:
            total = sum(sizes)
            imgs = _host_buffer((total,) + c0.images.shape[1:],
                                c0.images.dtype, pinned)
            labs = _host_buffer((total,), np.int32, pinned)
            np.concatenate([c.images for c in clients], out=imgs.numpy())
            np.concatenate([c.labels for c in clients], out=labs.numpy())
            offs.numpy()[client_ids] = np.cumsum([0] + sizes[:-1])
        else:
            n_max = max(sizes)
            k = round_up_to_mesh(len(clients), mesh)
            imgs = _host_buffer((k * n_max,) + c0.images.shape[1:],
                                c0.images.dtype, pinned)
            labs = _host_buffer((k * n_max,), np.int32, pinned)
            imgs.zero_()
            labs.zero_()
            img_np, lab_np = imgs.numpy(), labs.numpy()
            for i, c in enumerate(clients):
                img_np[i * n_max: i * n_max + len(c)] = c.images
                lab_np[i * n_max: i * n_max + len(c)] = c.labels
            offs.numpy()[client_ids] = np.arange(len(clients)) * n_max
        host = (imgs, labs, offs)
        self.nbytes = sum(t.numel() * t.element_size() for t in host)
        self.real_nbytes = (sum(c.images.nbytes + c.labels.size * 4
                                for c in clients)
                            + offs.numel() * offs.element_size())
        self.images, self.labels, self.offsets = (
            t.to(device, non_blocking=pinned) for t in host)

    def tensors(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The plane's three device tensors."""
        return self.images, self.labels, self.offsets


def _host_buffer(shape, dtype, pinned: bool) -> torch.Tensor:
    """An empty host tensor of numpy ``dtype`` to gather into, page-locked
    when ``pinned``."""
    return torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                       pin_memory=pinned)


@dataclasses.dataclass
class ClientData:
    """One FL device's private shard."""
    client_id: int
    images: np.ndarray
    labels: np.ndarray

    def __len__(self) -> int:
        return len(self.labels)


def make_clients(
    train: Dataset,
    *,
    scheme: str,
    num_devices: int,
    rng: np.random.Generator,
    xi: int = 2,
    alpha: float = 0.3,
) -> List[ClientData]:
    parts = partition(
        train.labels, scheme=scheme, k=num_devices, rng=rng, xi=xi, alpha=alpha
    )
    return [
        ClientData(d, train.images[p], train.labels[p])
        for d, p in enumerate(parts)
    ]


def client_weights(clients: List[ClientData]) -> np.ndarray:
    """|D_i| / |D| weights used by every aggregation rule in the paper."""
    sizes = np.asarray([len(c) for c in clients], np.float64)
    return sizes / sizes.sum()
