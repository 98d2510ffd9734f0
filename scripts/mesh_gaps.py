#!/usr/bin/env python3
"""The readings behind ``chip_smoke.py``'s phase 3k bound: how far each of
the phase's runs (``MESH_RUNS``: FedSR fused with ``mesh_data_axis`` and
FedAvg sharded at E=5, phase 3's path cut to 2 rounds) moves, on each
mesh size of ``--sizes``, when the initial weights move by a relative
1e-7 (``--draws`` draws of signs), when every step's trained parameters
move by a relative 1e-7 (``personalize_gaps.jittered_steps``: a
rounding-sized change in every product of the next step, as another
device's rounding makes), and when the run takes 1.03x its learning rate
(the phase's control), from the torch-drawn initial model of each of
``--seeds`` as ``chip_smoke.py`` draws it (seed 0 is the phase's).

    PYTHONPATH=src python scripts/mesh_gaps.py [--seeds 0 1 2]
        [--draws 3] [--sizes 1 8] [--stop-after 1] [--devices cpu]
        [--threads 4]

The runs go to the first of ``--devices``, on a sim mesh of ``size``
entries of that device; with ``--devices cuda cpu`` (on a machine with a
GPU) they run on the card and each line adds the model GPU against CPU,
which is what the phase holds to its bound. ``--stop-after N`` reads the
model after round N of the 2. The last lines give, for each
run and size, the largest rounding-sized reading and the least control.
About a minute a seed on a CPU at four threads.
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
sys.path.insert(0, str(ROOT / "scripts"))

from chip_smoke import (  # noqa: E402
    LR_CONTROL, MESH_RUNS, max_abs_diff, mesh_fl, sim_mesh,
)
from personalize_gaps import jittered_steps  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--draws", type=int, default=3)
    ap.add_argument("--sizes", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--devices", nargs="+", default=["cpu"])
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--stop-after", type=int, default=None)
    args = ap.parse_args()

    import torch

    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.fedsr_mlp import CONFIG
    from repro_torch.core.executor import run_experiment
    from repro_torch.data.synthetic import make_task
    from repro_torch.models.small import init_small_model, params_to_numpy

    torch.set_num_threads(args.threads)
    dev = args.devices[0]
    if "cuda" in args.devices:
        from repro_torch.kernels import build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.build(["fused_sgd"])
    train, test = make_task("mnist_like", seed=0)
    # chip_smoke.py's phase 3 config, which mesh_fl starts from
    phase3 = FLConfig(
        algorithm="fedsr", partition="pathological", num_devices=20,
        num_edges=5, ring_rounds=5, local_epochs=1, batch_size=32,
        rounds=10, engine="fused", use_fused_sgd=True, seed=0)

    def model(fl, init, size, device):
        with sim_mesh(size, device):
            res = run_experiment(
                task="mnist_like", model_cfg=CONFIG, fl=fl,
                eval_every=fl.rounds, init_params=init, device=device,
                stop_after=args.stop_after, train=train, test=test)
        return {k: v.cpu() for k, v in res.final_model.items()}

    worst, least, cross = {}, {}, {}
    for seed in args.seeds:
        init = params_to_numpy(init_small_model(
            torch.Generator().manual_seed(seed), CONFIG, torch.device("cpu")))
        signs = np.random.default_rng(seed + 100)
        for run in MESH_RUNS:
            fl = mesh_fl(phase3, *run)
            for size in args.sizes:
                key = (run[0], run[1], size)
                ref = model(fl, init, size, dev)
                moved = [max_abs_diff(model(fl, {k: (v * (
                    1 + 1e-7 * signs.choice([-1.0, 1.0], size=v.shape)))
                    .astype(np.float32) for k, v in init.items()}, size, dev),
                    ref) for _ in range(args.draws)]
                steps = []
                for d in range(args.draws):
                    with jittered_steps(1e-7, seed * 1000 + d):
                        steps.append(max_abs_diff(
                            model(fl, init, size, dev), ref))
                control = max_abs_diff(model(dataclasses.replace(
                    fl, init_lr=fl.init_lr * LR_CONTROL), init, size, dev),
                    ref)
                worst[key] = max(worst.get(key, 0.0), *moved, *steps)
                least[key] = min(least.get(key, float("inf")), control)
                line = (f"gaps: {run[0]}/{run[1]} mesh {size} seed {seed} on "
                        f"{dev}: initial weights moved by a relative 1e-7: "
                        + ", ".join(f"{g:.3e}" for g in moved)
                        + "; every step's trained parameters moved by a "
                        "relative 1e-7: " + ", ".join(f"{g:.3e}" for g in steps)
                        + f"; {LR_CONTROL}x lr: {control:.3e}")
                if dev != "cpu" and "cpu" in args.devices:
                    gap = max_abs_diff(ref, model(fl, init, size, "cpu"))
                    cross[key] = max(cross.get(key, 0.0), gap)
                    line += f"; GPU against CPU: {gap:.3e}"
                print(line, flush=True)
    for key in worst:
        line = (f"gaps: {key[0]}/{key[1]} mesh {key[2]}, seeds {args.seeds}: "
                f"the largest rounding-sized reading {worst[key]:.3e}, the "
                f"least control {least[key]:.3e}")
        if key in cross:
            line += f", the largest GPU against CPU {cross[key]:.3e}"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
