"""Device-resident algorithm state — MOON's previous local models and
SCAFFOLD's control variates (the port's twin of the device half of the JAX
package's ``core/state.py``).

A per-client field is one ``(K + 1, P)`` float32 stack of flat models in
the sorted-leaf layout of ``utils.tree``; row ``K`` is the dump row that
dead lanes scatter into, so it is never read into a real client's math
and it counts in ``peak_device_bytes`` as the reference's does. Which rows
are live is the host ``(K + 1,)`` ``seen`` mask: participation is drawn
by the planners, so no device readback is needed to know it.

The same functions serve both drivers: the per-round engines' state
update (``Moon``/``Scaffold.update_state``) and the fused engine's block
(``LocalTrainer.train_schedule``), so the two agree bit for bit.

``pack_client_rows``/``unpack_client_rows`` convert between a stack and
the ``{client_id: {leaf name: array}}`` layout of ``algo_state.msgpack``,
so a checkpoint saved by either package restores in the other.

Under the staged stores (``FLConfig.store="host"`` or ``"stream"``) a
field lives in a host numpy ``(K, P)`` arena (``host_stack``) instead,
and each block uploads only its visited rows as a ``(V + 1, P)`` cohort
carry (``stage_rows``; row ``V`` is the staged dump). ``rowmap_for`` is
the ``(K + 1,)`` fleet→cohort table the engines remap ``StateRef``
clients and scatter ids through, and ``unstage_rows`` writes the trained
rows back with one readback. The staged carry has the shape a V-client
fleet's stack would, so every consumer past the remap is unchanged and
peak device state bytes scale with the cohort.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import Layout, unravel


def client_stack(w_like: torch.Tensor, num_clients: int) -> torch.Tensor:
    """A zeroed ``(K + 1, P)`` stack shaped like the flat (P,) model
    ``w_like``, on its device; row K is the dump row."""
    return w_like.new_zeros((num_clients + 1, w_like.shape[-1]))


def gather_rows(stack: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of a client stack as a fresh (C, P) lane stack."""
    return torch.index_select(stack, 0, ids)


def scatter_rows(stack: torch.Tensor, ids: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """A new stack with the (C, P) lanes ``rows`` written into rows
    ``ids``; ``stack`` itself is left as it was, so rows resolved from it
    earlier keep their values. Only dead lanes share an id (the dump row,
    which no client reads)."""
    return stack.index_put((ids,), rows)


def scaffold_step(c: torch.Tensor, ci: torch.Tensor, ids: torch.Tensor,
                  locals_: torch.Tensor, w_before: torch.Tensor,
                  kl: torch.Tensor, mw: torch.Tensor,
                  frac: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round of SCAFFOLD's option-II variate update (Karimireddy et al.
    2020) as lane math, in the reference's order of operations:

        ci+ = ci - c + (w_glob - w_i) / (K_i * lr)
        c  += (participants / K) * sum_i mw_i * (ci+ - ci)

    ``c`` is the (P,) server variate, ``ci`` the (K + 1, P) client stack,
    ``ids`` (C,) the lanes' rows (dead lanes: the dump row K), ``locals_``
    the trained (C, P) lanes, ``w_before`` the round's (P,) global model,
    ``kl`` (C,) the float32-rounded ``K_i * lr``, ``mw`` (C,) the mean
    weights (1/live for live lanes, 0 for dead ones) and ``frac`` the
    0-dim participation fraction. Returns the new ``(c, ci)``."""
    rows = gather_rows(ci, ids)
    ci_new = rows - c.unsqueeze(0) + (w_before.unsqueeze(0) - locals_) \
        / kl.unsqueeze(1)
    mean_dc = mw @ (ci_new - rows)
    return c + frac * mean_dc, scatter_rows(ci, ids, ci_new)


def host_stack(w_like: torch.Tensor, num_clients: int) -> np.ndarray:
    """The host analogue of ``client_stack``: a zeroed numpy ``(K, P)``
    arena. It needs no dump row: dead lanes scatter into the staged
    carry's row V, which is dropped at write-back."""
    return np.zeros((num_clients, w_like.shape[-1]), np.float32)


def rowmap_for(visited, num_clients: int) -> np.ndarray:
    """The ``(K + 1,)`` int32 fleet→cohort row table of a staged block: a
    visited fleet id maps to its cohort row, every other id (the fleet
    dump index K included) to the staged dump row V."""
    visited = np.asarray(visited, np.int64)
    table = np.full(num_clients + 1, len(visited), np.int32)
    table[visited] = np.arange(len(visited), dtype=np.int32)
    return table


def stage_rows(arena: np.ndarray, visited, device) -> torch.Tensor:
    """Rows ``visited`` of a host arena as a ``(V + 1, P)`` carry on
    ``device``; row V is the staged dump, zeroed as ``client_stack``'s
    row K is. A GPU carry is copied from page-locked memory without
    blocking the host, in the current stream's order."""
    v = np.asarray(visited, np.int64)
    cuda = torch.device(device).type == "cuda"
    rows = torch.empty((len(v) + 1,) + arena.shape[1:], dtype=torch.float32,
                       pin_memory=cuda)
    host = rows.numpy()
    np.take(arena, v, axis=0, out=host[:len(v)])
    host[len(v):] = 0
    return rows.to(device, non_blocking=cuda)


def unstage_rows(arena: np.ndarray, visited,
                 staged: torch.Tensor) -> np.ndarray:
    """Write a block's trained cohort carry back into the host arena with
    one readback of its real rows (the dump row V is dropped)."""
    v = np.asarray(visited, np.int64)
    arena[v] = staged[:len(v)].cpu().numpy()
    return arena


def pack_client_rows(stack, seen: np.ndarray,
                     layout: Layout) -> Dict[int, Dict[str, np.ndarray]]:
    """Stack -> checkpoint layout: the seen rows of a device ``(K + 1, P)``
    stack (never the dump row) or of a host ``(K, P)`` arena as
    ``{client_id: {leaf name: array}}``, with one gather and one readback
    for the whole fleet."""
    seen = np.asarray(seen)
    ids = np.flatnonzero(seen[:len(seen) - 1])
    if isinstance(stack, np.ndarray):
        block = torch.from_numpy(stack[ids])
    else:
        block = gather_rows(stack, torch.as_tensor(ids, device=stack.device))
    leaves = {k: v.cpu().numpy() for k, v in unravel(block, layout).items()}
    return {int(i): {k: v[n] for k, v in leaves.items()}
            for n, i in enumerate(ids)}


def unpack_client_rows(rows: Dict[int, Dict[str, np.ndarray]],
                       layout: Layout, num_clients: int,
                       device) -> Tuple[object, np.ndarray]:
    """Checkpoint layout -> stack: the ``(K + 1, P)`` stack on ``device``
    and the host ``seen`` mask, from a ``{client_id: tree}`` dict. With
    ``device=False`` the stack is the staged stores' host ``(K, P)`` numpy
    arena instead (no dump row; nothing goes to a device)."""
    width = sum(int(np.prod(shape)) for _, shape in layout)
    n = num_clients if device is False else num_clients + 1
    arena = np.zeros((n, width), np.float32)
    seen = np.zeros(num_clients + 1, bool)
    for i, tree in rows.items():
        arena[int(i)] = np.concatenate(
            [np.asarray(tree[k], np.float32).reshape(-1) for k, _ in layout])
        seen[int(i)] = True
    if device is False:
        return arena, seen
    return torch.from_numpy(arena).to(device), seen
