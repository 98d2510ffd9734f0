"""AdamW — the large-architecture runtime's optimizer; the port's twin of
the JAX package's ``optim/adamw.py`` (torch ops, float32 bias
corrections as the reference computes them)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.optim.sgd import Tree, tree_map
from repro_torch.utils.tree import flatten_tree


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params: Tree) -> Dict[str, Any]:
        leaf = next(iter(flatten_tree(params).values()))
        return {"mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=leaf.device)}

    def update(self, grads: Tree, state: Dict[str, Any], params: Tree, lr):
        count = state["count"] + 1
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["nu"],
                      grads)
        n = count.to(torch.float32)
        c1 = 1 - torch.tensor(b1, dtype=torch.float32, device=n.device) ** n
        c2 = 1 - torch.tensor(b2, dtype=torch.float32, device=n.device) ** n

        def step(p, m, v):
            upd = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            return p - lr * (upd + self.weight_decay * p)

        return (tree_map(step, params, mu, nu),
                {"mu": mu, "nu": nu, "count": count})

