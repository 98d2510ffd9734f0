#!/usr/bin/env python3
"""How the paper CNN trains in the PyTorch port, on the CPU: the numbers
behind the CNN tolerances of ``tests/torch_parity.py`` and the learning
rate of ``chip_smoke.py``'s CNN phase.

    PYTHONPATH=src python scripts/cnn_sensitivity.py [--threads 4]

1. Divergence: one FedSR round of the full-width CNN on ``cifar10_like``
   (K=20, M=5, R=5, E=1, batch 32, fused engine) from four torch-drawn
   initial models at init_lr 0.01 (the default), 0.003 and 0.001: the
   largest per-lane loss of any step and the round's accuracy.
2. Sensitivity: the same run at init_lr 0.001 from initial weights that
   differ by a relative 1e-7 (three draws), and the narrow FedSR run of
   ``tests/test_torch_cnn.py`` (channels (8, 16, 16), all 4 rounds, three
   initial models, three draws each): how far each moves the trained
   model (largest absolute difference).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.configs.fedsr_cnn import CONFIG  # noqa: E402
from repro_torch.core.executor import run_experiment  # noqa: E402
from repro_torch.core.local import LocalTrainer  # noqa: E402
from repro_torch.data.synthetic import make_task  # noqa: E402
from repro_torch.models.small import (  # noqa: E402
    init_small_model, params_to_numpy,
)

CPU = torch.device("cpu")
FULL = FLConfig(algorithm="fedsr", partition="pathological", num_devices=20,
                num_edges=5, ring_rounds=5, local_epochs=1, batch_size=32,
                rounds=4, engine="fused", use_fused_sgd=True, seed=0)
NARROW = FLConfig(algorithm="fedsr", engine="fused", num_devices=4,
                  num_edges=2, ring_rounds=2, rounds=4, batch_size=8,
                  partition="pathological")


def torch_init(cfg, seed):
    return params_to_numpy(init_small_model(torch.Generator().manual_seed(seed),
                                            cfg, CPU))


def perturbed(init, rng):
    return {k: (v * (1 + 1e-7 * rng.standard_normal(v.shape))).astype(
        np.float32) for k, v in init.items()}


def max_abs_diff(a, b) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    train, test = make_task("cifar10_like", seed=0)
    run = dict(task="cifar10_like", model_cfg=CONFIG, eval_every=1,
               train=train, test=test, device="cpu", stop_after=1)

    losses = []
    lane_grads = LocalTrainer.lane_grads

    def logged(self, params, batch, anchor=None):
        out = lane_grads(self, params, batch, anchor)
        losses.append(float(out[0].max()))
        return out

    LocalTrainer.lane_grads = logged
    try:
        for lr in (0.01, 0.003, 0.001):
            fl = dataclasses.replace(FULL, init_lr=lr)
            for seed in range(4):
                losses.clear()
                res = run_experiment(fl=fl, init_params=torch_init(CONFIG,
                                                                   seed),
                                     **run)
                print(f"[diverge] init_lr {lr} seed {seed}: first loss "
                      f"{losses[0]:.2f}, largest {max(losses):.4g}, round-1 "
                      f"accuracy {res.history[-1].accuracy:.4f}, finite "
                      f"{all(bool(torch.isfinite(v).all()) for v in res.final_model.values())}",
                      flush=True)
    finally:
        LocalTrainer.lane_grads = lane_grads

    rng = np.random.default_rng(1)
    fl = dataclasses.replace(FULL, init_lr=0.001)
    init = torch_init(CONFIG, 0)
    base = run_experiment(fl=fl, init_params=init, **run).final_model
    for trial in range(3):
        other = run_experiment(fl=fl, init_params=perturbed(init, rng),
                               **run).final_model
        print(f"[sensitivity] full width, init_lr 0.001, round 1, draw "
              f"{trial}: max |diff| {max_abs_diff(base, other):.3e}",
              flush=True)

    narrow = dataclasses.replace(CONFIG, cnn_channels=(8, 16, 16))
    tr, te = make_task("cifar10_like", train_per_class=16, test_per_class=4)
    nrun = dict(task="cifar10_like", model_cfg=narrow, fl=NARROW,
                eval_every=2, train=tr, test=te, device="cpu")
    for seed in range(3):
        init = torch_init(narrow, seed)
        base = run_experiment(init_params=init, **nrun).final_model
        for trial in range(3):
            other = run_experiment(init_params=perturbed(init, rng),
                                   **nrun).final_model
            print(f"[sensitivity] narrow (8, 16, 16), 4 rounds, seed {seed} "
                  f"draw {trial}: max |diff| "
                  f"{max_abs_diff(base, other):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
