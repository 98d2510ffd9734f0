#!/usr/bin/env python3
"""How far apart the port's round-1 models land across engines, devices
and initial weights, for Table III's star and hierarchical rows on the
full-width paper MLP: the readings behind ``ENGINE_ROUND1_TOL`` in
``chip_smoke.py``.

    PYTHONPATH=src python scripts/engine_gap.py [--devices cpu]
        [--seeds 0 1 2] [--algorithms fedavg fedprox hieravg] [--threads 4]

Each (algorithm, seed) runs one round of ``mnist_like`` (2,000/400
images), pathological, K=20, M=5, batch 32, ``use_fused_sgd=True``, at
Table III's E and R (``benchmarks/fl_tables.py::_fl``), from the
torch-drawn initial model of that seed, through the fused, batched and
sequential engines on each device. It prints, per device, each engine's
largest |difference| from the fused engine's model, and, with two
devices, each engine's first device against its second; beside each, the
hidden units the differences above 1e-6 lie in (``chip_smoke.diff_spread``).
Then the control: the fused engine on the first device from initial weights
that differ by a relative 1e-7 (``--draws`` draws), against the
unperturbed run: how far a change of rounding size travels in one round.
With ``--devices cuda cpu`` it needs one card; TF32 is off.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import TABLE3, diff_spread, max_abs_diff  # noqa: E402
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.configs.fedsr_mlp import CONFIG  # noqa: E402
from repro_torch.core.executor import run_experiment  # noqa: E402
from repro_torch.data.synthetic import make_task  # noqa: E402
from repro_torch.models.small import (  # noqa: E402
    init_small_model, params_to_numpy,
)

# FedAvg beside chip_smoke's FedProx and HierFAVG settings: Table III's
# star baseline without the proximal term
SETTINGS = {"fedavg": {"local_epochs": 5, "ring_rounds": 1}, **TABLE3}
BASE = FLConfig(partition="pathological", num_devices=20, num_edges=5,
                batch_size=32, rounds=1, use_fused_sgd=True, seed=0)
ENGINES = ("fused", "batched", "sequential")


def perturbed(init, rng):
    return {k: (v * (1 + 1e-7 * rng.standard_normal(v.shape))).astype(
        np.float32) for k, v in init.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", nargs="+", default=["cpu"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    ap.add_argument("--algorithms", nargs="+", default=list(SETTINGS))
    ap.add_argument("--draws", type=int, default=3)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train, test = make_task("mnist_like", seed=0)
    rng = np.random.default_rng(1)
    for algorithm in args.algorithms:
        for seed in args.seeds:
            init = params_to_numpy(init_small_model(
                torch.Generator().manual_seed(seed), CONFIG,
                torch.device("cpu")))

            def round1(device, engine, init=init):
                fl = dataclasses.replace(BASE, algorithm=algorithm,
                                         engine=engine, **SETTINGS[algorithm])
                return run_experiment(
                    task="mnist_like", model_cfg=CONFIG, fl=fl, train=train,
                    test=test, init_params=init, device=device,
                    stop_after=1).final_model

            models = {(d, e): round1(d, e) for d in args.devices
                      for e in ENGINES}
            pairs = [((d, e), (d, "fused")) for d in args.devices
                     for e in ENGINES[1:]]
            if len(args.devices) == 2:
                pairs += [((args.devices[0], e), (args.devices[1], e))
                          for e in ENGINES]
            for a, b in pairs:
                print(f"[gap] {algorithm} seed {seed} {'/'.join(a)} against "
                      f"{'/'.join(b)}: max |diff| "
                      f"{max_abs_diff(models[a], models[b]):.3e} (above "
                      f"1e-6: {diff_spread(models[a], models[b])})",
                      flush=True)
            base = models[args.devices[0], "fused"]
            for draw in range(args.draws):
                other = round1(args.devices[0], "fused",
                               perturbed(init, rng))
                print(f"[gap] {algorithm} seed {seed} control, draw {draw}: "
                      f"{args.devices[0]}/fused from weights moved by a "
                      f"relative 1e-7: max |diff| "
                      f"{max_abs_diff(other, base):.3e} (above 1e-6: "
                      f"{diff_spread(other, base)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
