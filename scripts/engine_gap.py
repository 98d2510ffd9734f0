#!/usr/bin/env python3
"""How far apart the port's models land across engines, devices and
initial weights, for Table III's star and hierarchical rows and Table II's
MOON, SCAFFOLD and Centralized rows on the full-width paper MLP: the
readings behind ``ENGINE_ROUND1_TOL``, ``CENTRALIZED_EPOCH`` and
``TABLE2_STATE_TOL`` in ``chip_smoke.py``.

    PYTHONPATH=src python scripts/engine_gap.py [--devices cpu]
        [--seeds 0 1 2] [--algorithms fedavg fedprox hieravg] [--threads 4]
        [--lr-control 1.03]

Each (algorithm, seed) runs from the torch-drawn initial model of that
seed, pathological, K=20, M=5, batch 32, ``use_fused_sgd=True``: Table
III's FedAvg, FedProx and HierFAVG one round of ``mnist_like`` (2,000/400
images) at their E and R (``benchmarks/fl_tables.py::_fl``), Table II's
MOON, SCAFFOLD and Centralized two rounds of ``fashionmnist_like`` at
E=5, R=1 (``chip_smoke.py``'s phase 3e settings), and ``centralized-epoch``
Centralized's first epoch (one round at E=1), through the fused,
batched and sequential engines on each device (Centralized, which ignores
the engine, through the fused one). It prints, per device, each engine's
largest |difference| from the fused engine's model, and, with two
devices, each engine's first device against its second; beside each, the
hidden units the differences above 1e-6 lie in (``chip_smoke.diff_spread``)
and, for MOON and SCAFFOLD, each field of the saved state (MOON's previous
local models, SCAFFOLD's server variate ``c`` and client variates
``ci``). Then the controls on the first device's fused engine: initial
weights that differ by a relative 1e-7 (``--draws`` draws), and with
``--lr-control`` the learning rate scaled by that factor, each against the
unchanged run: how far a change of rounding size, and a small real change,
travel. With ``--devices cuda cpu`` it needs one card; TF32 is off.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    CENTRALIZED_EPOCH, TABLE2_ENGINES, TABLE2_KW, TABLE2_TASK, TABLE3,
    diff_spread, max_abs_diff, saved_state, state_diff,
)
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.configs.fedsr_mlp import CONFIG  # noqa: E402
from repro_torch.core.executor import run_experiment  # noqa: E402
from repro_torch.data.synthetic import make_task  # noqa: E402
from repro_torch.models.small import (  # noqa: E402
    init_small_model, params_to_numpy,
)

# (algorithm, task, FLConfig fields) of each row; FedAvg beside
# chip_smoke's FedProx and HierFAVG settings: Table III's star baseline
# without the proximal term; "centralized-epoch" is the first epoch of the
# pooled shard that chip_smoke holds Centralized's model at
SETTINGS = {
    "fedavg": ("fedavg", "mnist_like",
               {"local_epochs": 5, "ring_rounds": 1, "rounds": 1}),
    **{a: (a, "mnist_like", dict(kw, rounds=1)) for a, kw in TABLE3.items()},
    **{a: (a, TABLE2_TASK, dict(TABLE2_KW, rounds=2))
       for a in TABLE2_ENGINES},
    "centralized-epoch": ("centralized", TABLE2_TASK,
                          dict(TABLE2_KW, **CENTRALIZED_EPOCH))}
BASE = FLConfig(partition="pathological", num_devices=20, num_edges=5,
                batch_size=32, use_fused_sgd=True, seed=0)
ENGINES = ("fused", "batched", "sequential")


def perturbed(init, rng):
    return {k: (v * (1 + 1e-7 * rng.standard_normal(v.shape))).astype(
        np.float32) for k, v in init.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", nargs="+", default=["cpu"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    ap.add_argument("--algorithms", nargs="+",
                    default=["fedavg", "fedprox", "hieravg"])
    ap.add_argument("--draws", type=int, default=3)
    ap.add_argument("--lr-control", type=float, default=None)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tasks = {t: make_task(t, seed=0)
             for t in {SETTINGS[a][1] for a in args.algorithms}}
    rng = np.random.default_rng(1)
    for name in args.algorithms:
        algorithm, task, kw = SETTINGS[name]
        train, test = tasks[task]
        engines = TABLE2_ENGINES.get(algorithm, ENGINES)
        keeps_state = algorithm in ("moon", "scaffold")
        for seed in args.seeds:
            init = params_to_numpy(init_small_model(
                torch.Generator().manual_seed(seed), CONFIG,
                torch.device("cpu")))

            def run(device, engine, init=init, lr_scale=1.0):
                fl = dataclasses.replace(
                    BASE, algorithm=algorithm, engine=engine,
                    init_lr=BASE.init_lr * lr_scale, **kw)
                with tempfile.TemporaryDirectory() as ckdir:
                    res = run_experiment(
                        task=task, model_cfg=CONFIG, fl=fl, train=train,
                        test=test, init_params=init, device=device,
                        checkpoint_dir=ckdir if keeps_state else None,
                        checkpoint_every=fl.rounds)
                    state = saved_state(ckdir) if keeps_state else {}
                return res.final_model, state

            def report(what, a, b):
                states = "".join(
                    f"; {field} {d:.3e}"
                    for field, d in state_diff(a[1], b[1]).items())
                print(f"[gap] {name} seed {seed} {what}: max |diff| "
                      f"{max_abs_diff(a[0], b[0]):.3e} (above 1e-6: "
                      f"{diff_spread(a[0], b[0])}){states}", flush=True)

            runs = {(d, e): run(d, e) for d in args.devices for e in engines}
            pairs = [((d, e), (d, "fused")) for d in args.devices
                     for e in engines[1:]]
            if len(args.devices) == 2:
                pairs += [((args.devices[0], e), (args.devices[1], e))
                          for e in engines]
            for a, b in pairs:
                report(f"{'/'.join(a)} against {'/'.join(b)}", runs[a],
                       runs[b])
            base = runs[args.devices[0], "fused"]
            for draw in range(args.draws):
                report(f"control, draw {draw}: {args.devices[0]}/fused from "
                       f"weights moved by a relative 1e-7",
                       run(args.devices[0], "fused", perturbed(init, rng)),
                       base)
            if args.lr_control:
                report(f"control: {args.devices[0]}/fused at "
                       f"{args.lr_control}x the learning rate",
                       run(args.devices[0], "fused",
                           lr_scale=args.lr_control), base)
    return 0


if __name__ == "__main__":
    sys.exit(main())
