#!/usr/bin/env python3
"""The literals of ``chip_smoke.py``'s phase 3i, from the JAX package's
planners and privacy ledger on the CPU: for each of the phase's runs (the
``dp_sgd`` row of ``benchmarks/fl_tables.py::attack_defense_grid``, cut to
3 rounds in one block, and its clip-only twins), the ``fused_sgd``
launches and the dispatches the plans imply under the run's engine, the
block's comm records, and the ``(dp_epsilon, dp_delta)`` the ledger
reports after the block (``inf`` for a clip-only run).

    PYTHONPATH=src python scripts/dp_literals.py [--check]
        [--gaps] [--seeds 0 1] [--draws 3] [--stop-after 3]

The phase's settings: phase 3g's honest runs at the attack runs' edges
(the paper MLP at full width, ``mnist_like`` at 2,000/400 images,
pathological xi=2, K=20, ``num_edges=10``, batch 32,
``use_fused_sgd=True``, seed 0; FedSR at E=1, R=5 in rings of 2, FedAvg
at E=5, R=1) with ``dp_clip=1.0`` and ``dp_noise_mult`` 1.1 (the grid's
row) or 0 (the clip-only twins) on the fused engine, and FedSR's twin on
the batched and sequential engines. Neither the plans nor the ledger read
the weights or the noise, so the literals come from each package's
planners and ledger alone, without training: the script prints the
reference's literals as the Python table ``chip_smoke.py`` holds
(``DP_LITERALS``) and exits non-zero if the port gives others.
``--check`` also compares them with the table in ``chip_smoke.py``.
Seconds on a CPU.

``--gaps`` prints the readings behind phase 3i's GPU-against-CPU bound on
each clip-only fused run's model after ``--stop-after`` rounds, on the
port's CPU from the torch-drawn initial model of each of ``--seeds`` (as
``chip_smoke.py`` draws it): how far a relative 1e-7 change of the
initial weights (``--draws`` draws) and a 3% larger clip move the model
and its accuracy, and the share of lane-steps the clip bound. A few
minutes.
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

# the phase's own runs, settings and launch counts
from chip_smoke import (  # noqa: E402
    DP_CLIP, DP_CLIP_CONTROL, DP_RUNS as RUNS, dp_tag, engine_counts,
)

ROUNDS = 3


def phase_fl(base, algorithm: str, noise: float, engine: str):
    """Phase 3i's FLConfig of one run (``chip_smoke.dp_fl``) in the package
    whose config module is ``base``."""
    star = algorithm == "fedavg"
    return base.FLConfig(
        algorithm=algorithm, num_devices=20, num_edges=10,
        local_epochs=5 if star else 1, ring_rounds=1 if star else 5,
        rounds=ROUNDS, partition="pathological", xi=2, batch_size=32,
        engine=engine, use_fused_sgd=True, seed=0, dp_clip=DP_CLIP,
        dp_noise_mult=noise)


def literal(pkg: str, run, train) -> tuple:
    """A run's ``DP_LITERALS`` entry from package ``pkg``'s planner (the
    partition, then the 3-round block from ``default_rng(seed)``, as the
    executor plans it) and its ledger, charged as ``finish_block`` charges
    it; nothing trains."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    fl = phase_fl(mod("configs.base"), *run)
    cfg = mod("configs.fedsr_mlp").CONFIG
    rng = np.random.default_rng(fl.seed)
    clients = mod("data.pipeline").make_clients(
        train, scheme=fl.partition, num_devices=fl.num_devices, rng=rng,
        xi=fl.xi, alpha=fl.alpha)
    trainer = (mod("core.local").LocalTrainer(cfg, fl) if pkg == "repro"
               else mod("core.local").LocalTrainer(cfg, fl, "cpu"))
    planner = mod("core.algorithms").make_algorithm(run[0], trainer,
                                                    clients, fl)
    sched = planner.plan_schedule(0, ROUNDS, rng, {})
    planner.finish_block(sched, {}, None)
    launches, dispatches = engine_counts([(0, sched)], fl.engine)
    return (launches, dispatches, dict(sched.comm)) + planner.privacy.spent


def gaps(seeds, draws: int, stop_after: int) -> None:
    """Each clip-only fused run's sensitivity to a rounding-size change of
    the initial weights and to a 1.03x clip, on the port's CPU: its model
    after ``stop_after`` rounds."""
    import torch

    import repro_torch.configs.base as base
    import repro_torch.core.local as local
    from repro_torch.configs.fedsr_mlp import CONFIG
    from repro_torch.core.executor import run_experiment
    from repro_torch.data.synthetic import make_task
    from repro_torch.models.small import init_small_model, params_to_numpy

    train, test = make_task("mnist_like", seed=0)
    saved, counts = local.dp_clip_noise_, [0, 0]

    def counted(grads, clip, sigma, gen):
        fac = saved(grads, clip, sigma, gen)
        counts[0] += int((fac < 1).sum())
        counts[1] += fac.numel()
        return fac

    local.dp_clip_noise_ = counted

    def final(fl, init):
        return run_experiment(task="mnist_like", model_cfg=CONFIG, fl=fl,
                              eval_every=ROUNDS, init_params=init,
                              device="cpu", stop_after=stop_after,
                              train=train, test=test)

    def gap(a, b) -> float:
        accs.append(abs(a.final_accuracy - b.final_accuracy))
        a, b = a.final_model, b.final_model
        return max(float((a[k] - b[k]).abs().max()) for k in a)

    for seed in seeds:
        init = params_to_numpy(init_small_model(
            torch.Generator().manual_seed(seed), CONFIG, torch.device("cpu")))
        for run in RUNS:
            if run[1] or run[2] != "fused":
                continue
            fl = phase_fl(base, *run)
            counts[:] = [0, 0]
            ref = final(fl, init)
            share = counts[0] / counts[1]
            accs = []
            signs = np.random.default_rng(seed + 100)
            moved = [gap(final(fl, {k: (v * (1 + 1e-7 * signs.choice(
                [-1.0, 1.0], size=v.shape))).astype(np.float32)
                for k, v in init.items()}), ref) for _ in range(draws)]
            control = gap(final(dataclasses.replace(
                fl, dp_clip=fl.dp_clip * DP_CLIP_CONTROL), init), ref)
            print(f"gaps: {dp_tag(run)} seed {seed}, the model after round "
                  f"{stop_after}: initial weights moved by a relative 1e-7: "
                  + ", ".join(f"{g:.3e}" for g in moved)
                  + f"; {DP_CLIP_CONTROL}x clip: {control:.3e}; accuracy "
                  f"{ref.final_accuracy:.4f}, moved by at most "
                  f"{max(accs):.4f}; the clip bound {share:.4f} of "
                  f"{counts[1]} lane-steps", flush=True)
    local.dp_clip_noise_ = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--gaps", action="store_true")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--draws", type=int, default=3)
    ap.add_argument("--stop-after", type=int, default=ROUNDS)
    args = ap.parse_args()

    import chip_smoke
    import repro_torch.configs.base as port_base
    from repro.data.synthetic import make_task as ref_make_task
    from repro_torch.data.synthetic import make_task

    ref_train, _ = ref_make_task("mnist_like", seed=0)
    port_train, _ = make_task("mnist_like", seed=0)
    # chip_smoke.dp_fl from phase 3's config is this script's config
    phase3 = port_base.FLConfig(
        algorithm="fedsr", partition="pathological", num_devices=20,
        num_edges=5, ring_rounds=5, local_epochs=1, batch_size=32,
        rounds=10, engine="fused", use_fused_sgd=True, seed=0)
    table, bad = {}, 0
    for run in RUNS:
        if chip_smoke.dp_fl(phase3, *run) != phase_fl(port_base, *run):
            bad += 1
            print(f"{dp_tag(run)}: chip_smoke.dp_fl DIFFERS from this "
                  f"script's config", flush=True)
        table[run] = literal("repro", run, ref_train)
        port = literal("repro_torch", run, port_train)
        if port != table[run]:
            bad += 1
            print(f"{dp_tag(run)}: the port gives {port}  DIFFERS",
                  flush=True)
    print("DP_LITERALS = {")
    for run, (n, calls, comm, eps, delta) in table.items():
        items = ", ".join(f'"{k}": {v}' for k, v in comm.items())
        eps = 'float("inf")' if eps == float("inf") else repr(eps)
        print(f"    {run!r}: (\n        {n}, {calls}, {{{items}}},\n"
              f"        {eps}, {delta!r}),")
    print("}")
    if args.check:
        same = chip_smoke.DP_LITERALS == table
        bad += not same
        print(f"chip_smoke.DP_LITERALS "
              f"{'equals' if same else 'DIFFERS from'} the reference's",
              flush=True)
    if args.gaps:
        gaps(args.seeds, args.draws, args.stop_after)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
