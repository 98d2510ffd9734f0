#!/usr/bin/env python3
"""Where two devices' Centralized runs part, step by step: the model after
each of the first ``--steps`` SGD steps of the pooled visit (Table II's
setting: ``fashionmnist_like``, the full-width paper MLP, batch 32,
``use_fused_sgd=True``, the batch plan ``run_experiment`` draws), on each
device from the same initial weights, and their largest |difference| with
the hidden units it lies in (``chip_smoke.diff_spread``). A difference
that starts at rounding size in a few units and grows says a ReLU crossed
its kink on one device and not the other; one that starts large says the
two devices compute something else.

    PYTHONPATH=src python scripts/step_gap.py --devices cuda cpu
        [--seeds 2] [--steps 63] [--every 1]

The model after step k is ``LocalTrainer.train`` over the plan's first k
rows (momentum from zero at step 0, as the visit runs it), so the
readings cost k steps each. TF32 is off.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    TABLE2_KW, TABLE2_TASK, diff_spread, max_abs_diff,
)
from repro_torch.configs.base import FLConfig  # noqa: E402
from repro_torch.configs.fedsr_mlp import CONFIG  # noqa: E402
from repro_torch.core.local import LocalTrainer  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    ClientData, make_clients, plan_epoch_indices,
)
from repro_torch.data.synthetic import make_task  # noqa: E402
from repro_torch.models.small import (  # noqa: E402
    init_small_model, params_from_numpy, params_to_numpy,
)
from repro_torch.utils.tree import ravel_params, unravel  # noqa: E402

FL = FLConfig(algorithm="centralized", partition="pathological",
              num_devices=20, num_edges=5, batch_size=32,
              use_fused_sgd=True, seed=0, **TABLE2_KW)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", nargs=2, default=["cuda", "cpu"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[2])
    ap.add_argument("--steps", type=int, default=63)
    ap.add_argument("--every", type=int, default=1)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train, _ = make_task(TABLE2_TASK, seed=FL.seed)
    # the executor's stream: the partition draws first, then the visit's
    # plan (Centralized pools the shards in client order)
    rng = np.random.default_rng(FL.seed)
    clients = make_clients(train, scheme=FL.partition,
                           num_devices=FL.num_devices, rng=rng, xi=FL.xi,
                           alpha=FL.alpha)
    pool = ClientData(-1, np.concatenate([c.images for c in clients]),
                      np.concatenate([c.labels for c in clients]))
    plan = plan_epoch_indices(pool, FL.batch_size, 1, rng)
    trainers = {d: LocalTrainer(CONFIG, FL, d) for d in args.devices}
    for seed in args.seeds:
        init = params_to_numpy(init_small_model(
            torch.Generator().manual_seed(seed), CONFIG, torch.device("cpu")))
        for k in range(1, min(args.steps, len(plan)) + 1):
            if k % args.every and k != args.steps:
                continue
            models = {}
            for d, tr in trainers.items():
                w = ravel_params(params_from_numpy(init, torch.device(d)))
                models[d] = unravel(tr.train(w, pool, lr=FL.init_lr,
                                             plan=plan[:k]), tr.layout)
            a, b = (models[d] for d in args.devices)
            print(f"[step] seed {seed} after step {k}: {args.devices[0]} "
                  f"against {args.devices[1]}: max |diff| "
                  f"{max_abs_diff(a, b):.3e} (above 1e-6: "
                  f"{diff_spread(a, b)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
