"""SGD with (optional) momentum — the paper's client optimizer (momentum
0.5); the port's twin of the JAX package's ``optim/sgd.py``.

optax-like stateless API over nested dicts of tensors: ``init(params) ->
state``, ``update(grads, state, params, lr) -> (new_params, new_state)``;
the inputs are left as they are.

With ``fused=True`` the momentum update of each leaf is one call of the
fused kernel (``kernels/fused_sgd``) on a (1, n) view of the leaf's copy:
on a CUDA tensor it launches ``csrc/fused_sgd.cu`` (float32 only) or
raises; on a CPU tensor it runs the kernel's plain version, as every
wrapper of the port does. Unfused it is the same arithmetic in torch ops.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.kernels.fused_sgd.ops import fused_sgd_lanes

Tree = Dict[str, Any]       # nested dict of tensors


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of nested dicts of one structure."""
    return {k: (tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def _unzip(tree: Tree):
    """A tree of (a, b) pairs as two trees."""
    firsts, seconds = {}, {}
    for k, v in tree.items():
        firsts[k], seconds[k] = _unzip(v) if isinstance(v, dict) else v
    return firsts, seconds


@dataclasses.dataclass(frozen=True)
class SGD:
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0
    fused: bool = False

    def init(self, params: Tree):
        if self.momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(self, grads: Tree, state, params: Tree, lr):
        wd = self.weight_decay
        if wd:
            grads = tree_map(lambda g, p: g + wd * p, grads, params)
        if self.momentum == 0.0:
            return tree_map(lambda p, g: p - lr * g, params, grads), ()
        if self.fused:
            return _unzip(tree_map(self._fused_leaf(lr), params, grads,
                                   state))

        def step(p, g, m):
            m_new = self.momentum * m + g
            d = g + self.momentum * m_new if self.nesterov else m_new
            return p - lr * d, m_new

        return _unzip(tree_map(step, params, grads, state))

    def _fused_leaf(self, lr):
        def leaf(p, g, m):
            p_new, m_new = p.clone(), m.clone()
            lr_t = torch.as_tensor(lr, dtype=torch.float32,
                                   device=p.device).reshape(1)
            ok = torch.ones(1, dtype=torch.bool, device=p.device)
            fused_sgd_lanes(p_new.view(1, -1), g.contiguous().view(1, -1),
                            m_new.view(1, -1), ok, lr_t, reset=False,
                            momentum=self.momentum, nesterov=self.nesterov)
            return p_new, m_new
        return leaf
