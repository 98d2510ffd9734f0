#!/usr/bin/env python3
"""How far rounding alone moves an LM training step's gradient at the
reference's initial scale (ROADMAP C12): the readings behind the
tolerances of ``tests/test_torch_train.py`` and ``chip_smoke.py`` phase 9
(c).

    PYTHONPATH=src python scripts/lm_grad_gap.py --reference
    PYTHONPATH=src python scripts/lm_grad_gap.py --card

``--reference`` (the CPU, the JAX package): the tests' tiny config (2
layers, d 64, vocab 128), the reference's initial weights at its own scale
and with ``wq``, ``wk`` scaled by 0.1: the reference's gradient of
``lm_loss`` on one batch, and how far a relative 1e-7 change of the
weights (three draws) moves it, each leaf's max |diff| over its max
|grad|. ``--card`` (the port alone, no JAX; run it on the GPU): yi-9b at
full width and 2 layers, one step's gradient with the attention through
the kernels, through the plain version, and through the plain version
computed in float64, in bfloat16 (S = 4096) and float32 (S = 1024): each
leaf's ||diff|| / ||grad||, the worst leaf. It builds the kernels it
runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def reference() -> None:
    import jax
    import jax.numpy as jnp

    from repro.launch.train import lm_100m_config
    from repro.models.transformer import init_model, lm_loss

    cfg = dataclasses.replace(lm_100m_config(), num_layers=2, d_model=64,
                              d_ff=128, num_heads=2, num_kv_heads=2,
                              vocab_size=128, name="grad-gap")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(4, 17)).astype(np.int32)
    batch = {"inputs": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    grad = jax.jit(jax.grad(lambda p: lm_loss(p, batch, cfg)))
    for qk in (1.0, 0.1):
        base = jax.tree.map(np.asarray, init_model(jax.random.PRNGKey(0),
                                                   cfg))
        attn = base["blocks"]["pos0"]["attn"]
        for w in ("wq", "wk"):
            attn[w] = attn[w] * np.float32(qk)
        g0 = grad(base)
        rng = np.random.default_rng(5)
        worst = {}
        for _ in range(3):
            moved = jax.tree.map(lambda x: x * (1 + np.float32(1e-7) * rng.
                                                standard_normal(x.shape)
                                                .astype(np.float32)), base)
            g1 = grad(moved)
            for path, a in jax.tree_util.tree_leaves_with_path(g0):
                b = g1
                for k in path:
                    b = b[k.key]
                name = "/".join(k.key for k in path)
                gap = float(jnp.abs(a - b).max() / jnp.abs(a).max())
                worst[name] = max(worst.get(name, 0.0), gap)
        print(f"[reference] wq, wk x{qk}: a relative 1e-7 change of the "
              f"weights moves each leaf's gradient by (max |diff| / max "
              f"|grad|, worst of 3 draws):")
        for name, gap in worst.items():
            scale = float(jnp.abs(g0["embed"]["embed"]).max()) \
                if name == "embed/embed" else None
            print(f"  {name}: {gap:.3e}"
                  + (f" (max |grad| {scale:.4g})" if scale else ""))


def card() -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.configs.yi_9b import CONFIG as YI
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain,
    )
    from repro_torch.launch.steps import train_layout

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(["flash_attention", "flash_attention_bwd", "fused_sgd"])
    print(f"[card] {cs.nvidia_smi()}")
    for dtype, seq in (("bfloat16", 4096), ("float32", 1024)):
        cfg = dataclasses.replace(YI, num_layers=2, dtype=dtype)
        state = cs.train_state(cfg, cs.train_tcfg(), 1, "cuda",
                               gen=torch.Generator(device="cuda")
                               .manual_seed(0))
        toks = torch.from_numpy(cs.token_batches(cfg, 1, 1, seq, 1)[0]).cuda()
        batch = {"inputs": toks[..., :-1], "labels": toks[..., 1:]}
        layout = train_layout(cfg)
        grads = {name: cs.route_grads(cfg, route, state["params"], batch)[1]
                 for name, route in (("kernels", flash_attention),
                                     ("plain", flash_attention_plain),
                                     ("plain64", cs.attention_plain64))}
        for a, b in (("kernels", "plain"), ("plain64", "plain"),
                     ("kernels", "plain64")):
            gaps = cs._norm_gaps(grads[a], grads[b], layout)
            print(f"[card] yi-9b 2 layers {dtype} S={seq}: {a} against "
                  f"{b}, ||diff|| / ||grad|| worst {max(gaps.values()):.3e} "
                  + ", ".join(f"{k.split('/')[-1]} {v:.2e}"
                              for k, v in gaps.items()))
        del grads, state
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", action="store_true")
    ap.add_argument("--card", action="store_true")
    args = ap.parse_args()
    if args.reference:
        reference()
    if args.card:
        card()


if __name__ == "__main__":
    main()
