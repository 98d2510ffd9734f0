"""Client data partitioners (paper §IV-C), the port's copy of the JAX
package's ``data/partition.py``: same draws in the same order, so the
shards are identical.

* ``iid``          — random equal split.
* ``pathological`` — sort by label, slice into K*xi equal shards, each device
                     draws xi shards (most devices see only xi classes).
* ``dirichlet``    — per class c, draw p_c ~ Dir_K(alpha) and split class-c
                     samples across devices proportionally.

``poison_labels`` is the label-flip attack's permutation of a shard's
labels.
"""
from __future__ import annotations

from typing import List

import numpy as np


def iid_partition(labels: np.ndarray, k: int, rng: np.random.Generator) -> List[np.ndarray]:
    idx = rng.permutation(len(labels))
    return [np.sort(part) for part in np.array_split(idx, k)]


def pathological_partition(
    labels: np.ndarray, k: int, xi: int, rng: np.random.Generator
) -> List[np.ndarray]:
    order = np.argsort(labels, kind="stable")
    shards = np.array_split(order, k * xi)
    shard_ids = rng.permutation(k * xi)
    out = []
    for d in range(k):
        mine = shard_ids[d * xi : (d + 1) * xi]
        out.append(np.sort(np.concatenate([shards[s] for s in mine])))
    return out


def dirichlet_partition(
    labels: np.ndarray, k: int, alpha: float, rng: np.random.Generator,
    min_per_device: int = 2,
) -> List[np.ndarray]:
    if len(labels) < k * min_per_device:
        raise ValueError(
            f"dirichlet partition needs >= k*min_per_device = "
            f"{k * min_per_device} samples to give every device "
            f"{min_per_device}, got {len(labels)}")
    classes = np.unique(labels)
    buckets: List[list] = [[] for _ in range(k)]
    for c in classes:
        idx_c = np.where(labels == c)[0]
        rng.shuffle(idx_c)
        p = rng.dirichlet(np.full(k, alpha))
        splits = (np.cumsum(p) * len(idx_c)).astype(int)[:-1]
        for d, part in enumerate(np.split(idx_c, splits)):
            buckets[d].extend(part.tolist())
    # re-balance deficits by stealing from the largest OTHER bucket (the
    # deficient bucket itself must never be its own donor)
    for d in range(k):
        while len(buckets[d]) < min_per_device:
            sizes = [len(b) if i != d else -1 for i, b in enumerate(buckets)]
            donor = int(np.argmax(sizes))
            buckets[d].append(buckets[donor].pop())
    return [np.sort(np.asarray(b, dtype=np.int64)) for b in buckets]


def poison_labels(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Deterministic label-flip poison: ``label -> num_classes - 1 - label``
    (``core.adversary`` applies it to attacker shards)."""
    if num_classes < 2:
        raise ValueError(f"label flip needs >= 2 classes, got {num_classes}")
    return (num_classes - 1 - labels).astype(labels.dtype)


def partition(
    labels: np.ndarray, *, scheme: str, k: int, rng: np.random.Generator,
    xi: int = 2, alpha: float = 0.3,
) -> List[np.ndarray]:
    if k < 1:
        raise ValueError(f"need at least one device, got k={k}")
    if len(labels) < k:
        raise ValueError(
            f"cannot give {k} devices non-empty shards from "
            f"{len(labels)} samples")
    if scheme == "iid":
        return iid_partition(labels, k, rng)
    if scheme == "pathological":
        if len(labels) < k * xi:
            raise ValueError(
                f"pathological partition slices {k}*xi={k * xi} shards "
                f"but only {len(labels)} samples exist — some shards "
                "would be empty")
        return pathological_partition(labels, k, xi, rng)
    if scheme == "dirichlet":
        return dirichlet_partition(labels, k, alpha, rng)
    raise ValueError(f"unknown partition scheme {scheme!r}")
