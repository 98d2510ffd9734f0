#!/usr/bin/env python3
"""The readings behind ``chip_smoke.py``'s phase 3j bound: how far the
personalized fleet of each of the phase's (a) runs (``personalize_table``'s
alpha=0.1 rows, FedAvg and FedSR in full and head mode, cut to 2 global
rounds) moves when the initial weights move by a relative 1e-7
(``--draws`` draws of signs), and when the fine-tune runs at 1.03x its
learning rate (the phase's control), from the torch-drawn initial model of
each of ``--seeds`` as ``chip_smoke.py`` draws it; and for the stage
alone, run from each run's own 2-round global model, which is what the
phase holds GPU against CPU: the global model moved by a relative 1e-7,
every step's trained parameters moved by a relative 1e-7 (each one the
step's gradient reached, by ``1 +- 1e-7``, random signs: a rounding-sized
change in every product of the next step, as another device's rounding
makes), and the 1.03x fine-tune.

    PYTHONPATH=src python scripts/personalize_gaps.py [--seeds 0 1]
        [--draws 3] [--devices cpu] [--threads 4] [--stage-only]

The runs, the stages and their perturbations go to the first of
``--devices``; with ``--devices cuda cpu`` (on a machine with a GPU)
they run on the card and the lines add the fleet GPU against CPU, the
stage's from the GPU run's global model as ``chip_smoke.py`` reads it.
``--stage-only`` skips the whole runs' perturbations. About four minutes
on a CPU at four threads for two seeds.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    PERS_ALGOS, PERS_LR, PERS_LR_CONTROL, PERS_MODES, fleet_gap, pers_fl,
)


@contextlib.contextmanager
def jittered_steps(rel, seed):
    """After every ``fused_sgd`` step, each parameter the step's gradient
    reached (a nonzero gradient in its lane) moved by a relative ``rel``,
    signs from a generator seeded with ``seed``."""
    import torch

    import repro_torch.core.local as local

    step = local.fused_sgd_lanes
    gens = {}

    def jittered(p, grads, *a, **kw):
        gen = gens.setdefault(p.device, torch.Generator(
            device=p.device).manual_seed(seed))
        reached = torch.cat([g.reshape(p.shape[0], -1) for g in grads],
                            dim=1) != 0
        step(p, grads, *a, **kw)
        sign = torch.randint(0, 2, p.shape, generator=gen, device=p.device,
                             dtype=torch.float32)
        p.mul_(1 + rel * (2 * sign - 1) * reached)
    local.fused_sgd_lanes = jittered
    try:
        yield
    finally:
        local.fused_sgd_lanes = step


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--draws", type=int, default=3)
    ap.add_argument("--devices", nargs="+", default=["cpu"])
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--stage-only", action="store_true")
    args = ap.parse_args()

    import torch

    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.fedsr_mlp import CONFIG
    from repro_torch.core.executor import run_experiment
    from repro_torch.core.personalize import personalize_fleet
    from repro_torch.data.pipeline import make_clients
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
    # chip_smoke.py's phase 3 config, which pers_fl starts from
    phase3 = FLConfig(
        algorithm="fedsr", partition="pathological", num_devices=20,
        num_edges=5, ring_rounds=5, local_epochs=1, batch_size=32,
        rounds=10, engine="fused", use_fused_sgd=True, seed=0)

    def run(fl, init, device="cpu"):
        return run_experiment(task="mnist_like", model_cfg=CONFIG, fl=fl,
                              eval_every=fl.rounds, init_params=init,
                              device=device, train=train, test=test)

    def fleet(fl, init, device="cpu"):
        return run(fl, init, device).personalized_fleet

    def stage(fl, w, device="cpu"):
        clients = make_clients(train, scheme=fl.partition,
                               num_devices=fl.num_devices,
                               rng=np.random.default_rng(fl.seed), xi=fl.xi,
                               alpha=fl.alpha)
        return personalize_fleet(CONFIG, fl, clients, w, test,
                                 device=device).fleet

    worst, least = 0.0, float("inf")
    s_worst = {m: 0.0 for m in PERS_MODES}
    s_least = {m: float("inf") for m in PERS_MODES}
    for seed in args.seeds:
        init = params_to_numpy(init_small_model(
            torch.Generator().manual_seed(seed), CONFIG, torch.device("cpu")))
        signs = np.random.default_rng(seed + 100)
        for algorithm in PERS_ALGOS:
            for mode in PERS_MODES:
                fl = pers_fl(phase3, algorithm, mode)
                whole = run(fl, init, dev)
                ref = whole.personalized_fleet
                w = {k: v.cpu().numpy() for k, v in whole.final_model.items()}
                alone = stage(fl, w, dev)
                s_moved = [fleet_gap(stage(fl, {k: (v * (
                    1 + 1e-7 * signs.choice([-1.0, 1.0], size=v.shape)))
                    .astype(np.float32) for k, v in w.items()}, dev), alone)
                    for _ in range(args.draws)]
                s_steps = []
                for d in range(args.draws):
                    with jittered_steps(1e-7, seed * 1000 + d):
                        s_steps.append(fleet_gap(stage(fl, w, dev), alone))
                lr_fl = dataclasses.replace(fl, personalize=dataclasses.replace(
                    fl.personalize, lr=PERS_LR * PERS_LR_CONTROL))
                s_control = fleet_gap(stage(lr_fl, w, dev), alone)
                s_worst[mode] = max(s_worst[mode], *s_moved, *s_steps)
                s_least[mode] = min(s_least[mode], s_control)
                line = (f"gaps: {algorithm}/{mode} seed {seed} on {dev}, the "
                        f"stage alone from the run's global model: the "
                        f"global model moved by a relative 1e-7: "
                        + ", ".join(f"{g:.3e}" for g in s_moved)
                        + "; every step's trained parameters moved by a "
                        "relative 1e-7: " + ", ".join(f"{g:.3e}" for g in s_steps)
                        + f"; {PERS_LR_CONTROL}x fine-tune lr: "
                        f"{s_control:.3e}")
                if dev != "cpu" and "cpu" in args.devices:
                    line += (f"; GPU against CPU: "
                             f"{fleet_gap(alone, stage(fl, w, 'cpu')):.3e}")
                print(line, flush=True)
                if args.stage_only:
                    continue
                moved = [fleet_gap(fleet(fl, {k: (v * (1 + 1e-7 * signs.choice(
                    [-1.0, 1.0], size=v.shape))).astype(np.float32)
                    for k, v in init.items()}, dev), ref)
                    for _ in range(args.draws)]
                control = fleet_gap(fleet(lr_fl, init, dev), ref)
                worst, least = max(worst, *moved), min(least, control)
                line = (f"gaps: {algorithm}/{mode} seed {seed}, the "
                        f"personalized fleet: initial weights moved by a "
                        f"relative 1e-7: "
                        + ", ".join(f"{g:.3e}" for g in moved)
                        + f"; {PERS_LR_CONTROL}x fine-tune lr: "
                        f"{control:.3e}")
                if dev != "cpu" and "cpu" in args.devices:
                    line += (f"; GPU against CPU: "
                             f"{fleet_gap(ref, fleet(fl, init, 'cpu')):.3e}")
                print(line, flush=True)
    if not args.stage_only:
        print(f"gaps: whole runs: the largest perturbed fleet {worst:.3e}, "
              f"the least control {least:.3e}", flush=True)
    for m in PERS_MODES:
        print(f"gaps: the stage alone, {m} mode: the largest perturbed fleet "
              f"{s_worst[m]:.3e}, the least control {s_least[m]:.3e}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
