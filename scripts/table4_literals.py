#!/usr/bin/env python3
"""The literals of ``chip_smoke.py``'s phase 3f, from the JAX package and
the port on the CPU: for Table IV's K=100 fleet
(``benchmarks/fl_tables.py::table4_scalability``, participation 0.2) at
phase 3f's settings, each (algorithm, store, prefetch) run's
``peak_device_bytes``, the trainer's ``h2d_bytes`` and the ``fused_sgd``
steps its plans imply.

    PYTHONPATH=src python scripts/table4_literals.py [--rounds 3]
        [--gaps] [--seeds 0 1] [--draws 3]

FedSR (E=1, R=5) and MOON (E=5, R=1) on the paper MLP at full width
(199,210 parameters), ``mnist_like`` at 2,000/400 images, pathological
xi=2, ``num_edges=25``, the fused engine with ``use_fused_sgd=True``, an
eval every round (so every round is its own block and is staged again),
from the reference's initial weights (``PRNGKey(0)``). It prints one line
per run with both packages' numbers and whether they agree, and exits
non-zero if any differs. About a minute on a CPU.

``--gaps`` also prints the readings behind phase 3f's bound on the (host,
1) model, on the port's CPU from the torch-drawn initial model of each of
``--seeds`` (as ``chip_smoke.py`` draws it): how far a relative 1e-7
change of the initial weights (``--draws`` draws) and a 3% larger
learning rate move each algorithm's 3-round model.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

RUNS = [("device", 0), ("host", 0), ("host", 1), ("stream", 0),
        ("stream", 1)]
ALGORITHMS = {"fedsr": {"local_epochs": 1, "ring_rounds": 5},
              "moon": {"local_epochs": 5, "ring_rounds": 1}}


def table4_fl(fl_cls, algorithm: str, store: str, prefetch: int,
              rounds: int):
    """Phase 3f's FLConfig in either package."""
    return fl_cls(algorithm=algorithm, num_devices=100, num_edges=25,
                  rounds=rounds, partition="pathological", xi=2,
                  participation=0.2, engine="fused", use_fused_sgd=True,
                  store=store, prefetch=prefetch, seed=0,
                  **ALGORITHMS[algorithm])


def fused_steps(blocks) -> int:
    """The fused engine's ``fused_sgd`` launches the blocks' plans imply:
    rounds x hops x the block's longest visit."""
    steps = 0
    for sched in blocks:
        groups = [g for p in sched.plans for g in p.groups]
        hops = [h for g in groups for h in g.hops]
        H = max(len(g.hops) for g in groups)
        S = max(p.shape[0] for h in hops for p in h.plans if p is not None)
        steps += len(groups) * H * S
    return steps


def gaps(rounds: int, seeds, draws: int) -> None:
    """The (host, 1) runs' sensitivity to a rounding-size change of the
    initial weights and to a 1.03x learning rate, on the port's CPU."""
    import dataclasses

    import torch

    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.fedsr_mlp import CONFIG
    from repro_torch.core.executor import run_experiment
    from repro_torch.models.small import init_small_model, params_to_numpy

    def final(fl, init):
        return run_experiment(task="mnist_like", model_cfg=CONFIG, fl=fl,
                              eval_every=1, init_params=init,
                              device="cpu").final_model

    def gap(a, b) -> float:
        return max(float((a[k] - b[k]).abs().max()) for k in a)

    for seed in seeds:
        init = params_to_numpy(init_small_model(
            torch.Generator().manual_seed(seed), CONFIG, torch.device("cpu")))
        for algorithm in ALGORITHMS:
            fl = table4_fl(FLConfig, algorithm, "host", 1, rounds)
            base = final(fl, init)
            signs = np.random.default_rng(seed + 100)
            moved = [gap(final(fl, {k: (v * (1 + 1e-7 * signs.choice(
                [-1.0, 1.0], size=v.shape))).astype(np.float32)
                for k, v in init.items()}), base) for _ in range(draws)]
            control = gap(final(dataclasses.replace(
                fl, init_lr=fl.init_lr * 1.03), init), base)
            print(f"gaps: {algorithm} seed {seed}: initial weights moved by "
                  f"a relative 1e-7: "
                  + ", ".join(f"{g:.3e}" for g in moved)
                  + f"; 1.03x learning rate: {control:.3e}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--gaps", action="store_true")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--draws", type=int, default=3)
    args = ap.parse_args()

    import jax

    import repro.core.executor as ref_executor
    from repro.configs.base import FLConfig as RefFL
    from repro.configs.fedsr_mlp import CONFIG as REF_MLP
    from repro.models.small import init_small_model
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.fedsr_mlp import CONFIG
    from repro_torch.core.executor import run_experiment

    init = {k: np.asarray(v) for k, v in init_small_model(
        jax.random.PRNGKey(0), REF_MLP).items()}
    bad = 0
    for algorithm in ALGORITHMS:
        for store, prefetch in RUNS:
            made = []

            class Recorded(ref_executor.LocalTrainer):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k)
                    made.append(self)

            ref_executor.LocalTrainer, orig = Recorded, ref_executor.LocalTrainer
            try:
                ref = ref_executor.run_experiment(
                    task="mnist_like", model_cfg=REF_MLP,
                    fl=table4_fl(RefFL, algorithm, store, prefetch,
                                 args.rounds), eval_every=1)
            finally:
                ref_executor.LocalTrainer = orig
            blocks = []
            port = run_experiment(
                task="mnist_like", model_cfg=CONFIG,
                fl=table4_fl(FLConfig, algorithm, store, prefetch,
                             args.rounds), eval_every=1, init_params=init,
                device="cpu", on_block=lambda t, s, b=blocks: b.append(s))
            want = (ref.peak_device_bytes, made[0].h2d_bytes)
            got = (port.peak_device_bytes, port.h2d_bytes)
            err = max(float(np.abs(np.asarray(ref.final_model[k])
                                   - port.final_model[k].numpy()).max())
                      for k in init)
            same = want == got
            bad += not same
            print(f"{algorithm} store={store} prefetch={prefetch}: "
                  f"peak_device_bytes {got[0]} (reference {want[0]}), "
                  f"h2d_bytes {got[1]} (reference {want[1]}), fused_sgd "
                  f"steps {fused_steps(blocks)}, final model "
                  f"{err:.3e} from the reference's, accuracies "
                  f"{[round(r.accuracy, 4) for r in port.history]}"
                  f"{'' if same else '  DIFFERS'}", flush=True)
    if args.gaps:
        gaps(args.rounds, args.seeds, args.draws)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
