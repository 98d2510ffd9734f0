#!/usr/bin/env python3
"""The literals of ``chip_smoke.py``'s phase 3h, from the JAX package's
planners on the CPU: for each of the phase's runs (the ``median``,
``trimmed_mean`` and ``krum`` columns of
``benchmarks/fl_tables.py::attack_defense_grid``, cut to 3 rounds in one
block), the ``fused_sgd`` launches and the dispatches the plans imply
under the run's engine, the block's comm records, the H2D bytes the
engine ships for the block, and the robust reduces the plans imply (one
a visit group: one a round for a cohort or FedSR's rings, R a round for
HierFAVG).

    PYTHONPATH=src python scripts/robust_literals.py [--check]
        [--gaps] [--seeds 0 1] [--draws 3] [--stop-after 3]

The phase's settings: phase 3g's attack runs (the paper MLP at full width,
``mnist_like`` at 2,000/400 images, pathological xi=2, K=20,
``num_edges=10``, batch 32, ``use_fused_sgd=True``, seed 0; FedSR at E=1,
R=5, FedAvg at E=5, R=1) under ``signflip20``, ``scale20`` and
``labelflip20``, each with the three robust reducers on the fused engine,
``krum_f=4`` and ``trim_frac`` at its default 0.2 as the grid sets them;
plus FedSR under ``signflip20`` with the median on the batched engine and
HierFAVG under ``scale20`` with the trimmed mean. Planning draws nothing
from the weights, and the H2D bytes follow from the plans and the
clients, so the literals come from each package's planner and stacking
code alone, without training: the script prints the reference's literals
as the Python table ``chip_smoke.py`` holds (``ROBUST_LITERALS``) and
exits non-zero if the port gives others. ``--check`` also compares them
with the table in ``chip_smoke.py``. Under a minute on a CPU.

``--gaps`` prints the readings behind phase 3h's GPU-against-CPU bounds
on each run's model after ``--stop-after`` rounds, on the port's CPU from
the torch-drawn initial model of each of ``--seeds`` (as ``chip_smoke.py``
draws it): how far a relative 1e-7 change of the initial weights
(``--draws`` draws) and a 3% larger learning rate move the model and its
accuracy. Tens of minutes.
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

# the phase's own attacks, runs and launch counts
from chip_smoke import (  # noqa: E402
    ATTACKS_3G as ATTACKS, ROBUST_RUNS as RUNS, engine_counts,
)

ROUNDS = 3


def phase_fl(base, algorithm: str, attack: str, reducer: str, engine: str):
    """Phase 3h's FLConfig of one run (``chip_smoke.robust_fl``) in the
    package whose config module is ``base``."""
    star = algorithm == "fedavg"
    return base.FLConfig(
        algorithm=algorithm, num_devices=20, num_edges=10,
        local_epochs=5 if star else 1, ring_rounds=1 if star else 5,
        rounds=ROUNDS, partition="pathological", xi=2, batch_size=32,
        engine=engine, use_fused_sgd=True, seed=0, reducer=reducer, krum_f=4,
        adversary=base.AdversaryConfig(**ATTACKS[attack]))


def _nbytes(a) -> int:
    """H2D bytes of one host array as both packages meter them (64-bit
    dtypes count as the 32-bit arrays JAX ships)."""
    a = np.asarray(a)
    return a.size * min(a.dtype.itemsize, 4)


def block_h2d(pkg: str, planner, sched, clients) -> int:
    """The H2D bytes the run's engine ships for the block: the fused
    engine's stacked block arrays, or the batched engine's per-hop batch
    stacks and step masks."""
    import importlib

    if planner.fl.engine == "fused":
        plans, lrs = sched.plans, np.zeros(len(sched.plans), np.float32)
        eng = planner.engine
        xs = (eng._stack_hier_schedule(plans, lrs)
              if len(plans[0].groups) > 1
              else eng._stack_cohort_schedule(plans, lrs, "plain", {}))
        return sum(_nbytes(v) for v in xs.values())
    stack_plans = importlib.import_module(f"{pkg}.data.pipeline").stack_plans
    total = 0
    for plan in sched.plans:
        for g in plan.groups:
            B = next(p.shape[1] for h in g.hops for p in h.plans
                     if p is not None)
            for hop in g.hops:
                batches, valid = stack_plans(
                    [clients[i] for i in hop.ids], list(hop.plans),
                    pad_to=g.lanes, width=B)
                total += (sum(_nbytes(v) for v in batches.values())
                          + _nbytes(valid))
    return total


def literal(pkg: str, planner, sched, clients) -> tuple:
    """A run's ``ROBUST_LITERALS`` entry: (``fused_sgd`` launches,
    dispatches, comm, H2D bytes, robust reduces)."""
    launches, dispatches = engine_counts([(0, sched)], planner.fl.engine)
    reduces = sum(len(p.groups) for p in sched.plans)
    return (launches, dispatches, dict(sched.comm),
            block_h2d(pkg, planner, sched, clients), reduces)


def plan_block(pkg: str, run, train):
    """One run's 3-round block as the executor plans it (the partition,
    the label-flip poison, then the plans from ``default_rng(seed)``):
    ``(planner, schedule, clients)``; nothing trains."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    fl = phase_fl(mod("configs.base"), *run)
    cfg = mod("configs.fedsr_mlp").CONFIG
    rng = np.random.default_rng(fl.seed)
    clients = mod("data.pipeline").make_clients(
        train, scheme=fl.partition, num_devices=fl.num_devices, rng=rng,
        xi=fl.xi, alpha=fl.alpha)
    clients = mod("core.adversary").AdversaryState(
        fl.adversary, fl.num_devices).poison_clients(clients, cfg.num_classes)
    trainer = (mod("core.local").LocalTrainer(cfg, fl) if pkg == "repro"
               else mod("core.local").LocalTrainer(cfg, fl, "cpu"))
    planner = mod("core.algorithms").make_algorithm(run[0], trainer,
                                                    clients, fl)
    sched = planner.plan_schedule(0, ROUNDS, rng, {})
    assert all(g.agg.reducer == run[2] for p in sched.plans
               for g in p.groups), run
    return planner, sched, clients


def gaps(seeds, draws: int, stop_after: int) -> None:
    """Each run's sensitivity to a rounding-size change of the initial
    weights and to a 1.03x learning rate, on the port's CPU: its model
    after ``stop_after`` rounds."""
    import torch

    import repro_torch.configs.base as base
    from repro_torch.configs.fedsr_mlp import CONFIG
    from repro_torch.core.executor import run_experiment
    from repro_torch.data.synthetic import make_task
    from repro_torch.models.small import init_small_model, params_to_numpy

    train, test = make_task("mnist_like", seed=0)

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
            fl = phase_fl(base, *run)
            ref = final(fl, init)
            accs = []
            signs = np.random.default_rng(seed + 100)
            moved = [gap(final(fl, {k: (v * (1 + 1e-7 * signs.choice(
                [-1.0, 1.0], size=v.shape))).astype(np.float32)
                for k, v in init.items()}), ref) for _ in range(draws)]
            control = gap(final(dataclasses.replace(
                fl, init_lr=fl.init_lr * 1.03), init), ref)
            print(f"gaps: {'/'.join(run)} seed {seed}, the model after "
                  f"round {stop_after}: initial weights moved by a relative "
                  f"1e-7: " + ", ".join(f"{g:.3e}" for g in moved)
                  + f"; 1.03x learning rate: {control:.3e}; accuracy "
                  f"{ref.final_accuracy:.4f}, moved by at most "
                  f"{max(accs):.4f}", flush=True)


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
    # chip_smoke.robust_fl from phase 3's config is this script's config
    phase3 = port_base.FLConfig(
        algorithm="fedsr", partition="pathological", num_devices=20,
        num_edges=5, ring_rounds=5, local_epochs=1, batch_size=32,
        rounds=10, engine="fused", use_fused_sgd=True, seed=0)
    table, bad = {}, 0
    for run in RUNS:
        if chip_smoke.robust_fl(phase3, *run) != phase_fl(port_base, *run):
            bad += 1
            print(f"{'/'.join(run)}: chip_smoke.robust_fl DIFFERS from "
                  f"this script's config", flush=True)
        table[run] = literal("repro", *plan_block("repro", run, ref_train))
        port = literal("repro_torch",
                       *plan_block("repro_torch", run, port_train))
        if port != table[run]:
            bad += 1
            print(f"{'/'.join(run)}: the port gives {port}  DIFFERS",
                  flush=True)
    print("ROBUST_LITERALS = {")
    for run, (n, calls, comm, h2d, reduces) in table.items():
        items = [f'"{k}": {v}' for k, v in comm.items()]
        line = f"        {n}, {calls}, {{{', '.join(items)}}}, {h2d}, {reduces}),"
        if len(line) > 79:
            line = (f"        {n}, {calls}, {{{', '.join(items[:2])},\n"
                    f"         {', '.join(items[2:])}}}, {h2d}, {reduces}),")
        print(f"    {run!r}: (\n{line}")
    print("}")
    if args.check:
        same = chip_smoke.ROBUST_LITERALS == table
        bad += not same
        print(f"chip_smoke.ROBUST_LITERALS "
              f"{'equals' if same else 'DIFFERS from'} the reference's",
              flush=True)
    if args.gaps:
        gaps(args.seeds, args.draws, args.stop_after)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
