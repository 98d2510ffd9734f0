"""Msgpack pytree checkpoints in the JAX package's layout
(``checkpoint/io.py``), so a checkpoint written by either package loads in
the other.

A tree is a dict (keys as strings, in sorted order, as the reference's
``jax.device_get`` rebuilds a dict before it is packed), a list or tuple (``{"__seq__": [...],
"__tuple__": bool}``) or an array leaf (``{"__nd__": True, "dtype": str,
"shape": [...], "data": raw bytes}``), packed with
``msgpack.packb(use_bin_type=True)`` as the reference packs it. Tensors
are saved from the host; ``restore`` returns numpy arrays, which the
caller moves to its device. ``msgpack`` is imported only when a
checkpoint is written or read, so a run without checkpoints does not
need it.
"""
from __future__ import annotations

import os

import numpy as np
import torch

_SENTINEL = "__nd__"


def _pack_leaf(x) -> dict:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = np.asarray(x)
    return {_SENTINEL: True, "dtype": str(arr.dtype),
            "shape": list(arr.shape), "data": arr.tobytes()}


def _encode(tree):
    if isinstance(tree, dict):
        return {str(k): _encode(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return {"__seq__": [_encode(v) for v in tree],
                "__tuple__": isinstance(tree, tuple)}
    return _pack_leaf(tree)


def _decode(obj):
    if isinstance(obj, dict) and obj.get(_SENTINEL):
        arr = np.frombuffer(obj["data"], dtype=np.dtype(obj["dtype"]))
        return arr.reshape(obj["shape"]).copy()
    if isinstance(obj, dict) and "__seq__" in obj:
        seq = [_decode(v) for v in obj["__seq__"]]
        return tuple(seq) if obj["__tuple__"] else seq
    if isinstance(obj, dict):
        return {k: _decode(v) for k, v in obj.items()}
    raise ValueError(f"cannot decode {type(obj)}")


def save(path: str, tree) -> None:
    import msgpack

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack.packb(_encode(tree), use_bin_type=True))


def restore(path: str):
    import msgpack

    with open(path, "rb") as f:
        return _decode(msgpack.unpackb(f.read(), raw=False,
                                       strict_map_key=False))
