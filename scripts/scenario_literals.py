#!/usr/bin/env python3
"""The literals of ``chip_smoke.py``'s phase 3g, from the JAX package's
planners on the CPU: for each of the phase's runs (the scenario curves of
``benchmarks/fl_tables.py::scenario_curves`` and the ``weighted_mean``
column of ``attack_defense_grid``, cut to 3 rounds in one block), the
real SGD steps of each round's plans, the block's comm records, the
simulated seconds the meter accumulates, and the ``fused_sgd`` launches
the plans imply under the fused engine (and the launches and calls under
the batched engine for the two runs the phase also runs batched).

    PYTHONPATH=src python scripts/scenario_literals.py [--check]
        [--gaps] [--seeds 0 1] [--draws 3] [--stop-after 3]

The phase's settings: the paper MLP at full width (199,210 parameters),
``mnist_like`` at 2,000/400 images, pathological xi=2, K=20, batch 32,
the fused engine with ``use_fused_sgd=True``, seed 0; FedSR and HierFAVG
at E=1, R=5, FedAvg at E=5, R=1 (``fl_tables._fl``'s matched budget). The
scenario runs use ``num_edges=5`` under ``drop30``, ``straggle`` and
``stale``; the attack runs ``num_edges=10`` (FedSR's rings of 2) under
``signflip20``, ``scale20`` and ``labelflip20``, HierFAVG under
``scale20`` only. Planning draws nothing from the weights, so the
literals come from each package's planner alone, without training: the
script plans every run with the reference and with the port, prints the
reference's literals as the Python table ``chip_smoke.py`` holds
(``SCENARIO_LITERALS``) and exits non-zero if the port plans otherwise.
``--check`` also compares them with the table in ``chip_smoke.py``.
Seconds on a CPU.

``--gaps`` prints the readings behind phase 3g's GPU-against-CPU bounds
on each run's model after ``--stop-after`` rounds (3: the whole run; 1:
round 1), on the port's CPU from the torch-drawn initial model of each
of ``--seeds`` (as ``chip_smoke.py`` draws it): how far a relative 1e-7
change of the initial weights (``--draws`` draws) and a 3% larger
learning rate move the model and its accuracy. A few minutes.
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

# the phase's own scenarios, attacks, block literal and launch counts
from chip_smoke import (  # noqa: E402
    ATTACKS_3G as ATTACKS, SCENARIOS_3G as SCENARIOS, engine_counts,
    scenario_literal as literal,
)

# (algorithm, scenario or attack name) of every phase 3g run, in order
RUNS = ([(a, s) for s in SCENARIOS for a in ("fedsr", "fedavg", "hieravg")]
        + [(a, k) for k in ATTACKS for a in ("fedsr", "fedavg")]
        + [("hieravg", "scale20")])
# the runs phase 3g also runs on the batched engine
BATCHED = (("fedsr", "drop30"), ("fedsr", "signflip20"))
ROUNDS = 3


def phase_fl(base, algorithm: str, name: str):
    """Phase 3g's FLConfig of one run (``chip_smoke.scenario_fl``) in the
    package whose config module is ``base`` (``repro.configs.base`` or
    ``repro_torch.configs.base``)."""
    star = algorithm == "fedavg"
    kw = {}
    if name in SCENARIOS:
        kw["scenario"] = base.ScenarioConfig(**SCENARIOS[name])
    else:
        kw["adversary"] = base.AdversaryConfig(**ATTACKS[name])
    return base.FLConfig(
        algorithm=algorithm, num_devices=20,
        num_edges=10 if name in ATTACKS else 5,
        local_epochs=5 if star else 1, ring_rounds=1 if star else 5,
        rounds=ROUNDS, partition="pathological", xi=2, batch_size=32,
        engine="fused", use_fused_sgd=True, seed=0, **kw)


def plan_block(pkg: str, algorithm: str, name: str, train):
    """One run's 3-round block as the executor plans it: the partition
    and then the plans from ``default_rng(seed)``, after the label-flip
    poison (which draws from the adversary's own seed); the trainer only
    sizes the engine, and nothing trains."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    fl = phase_fl(mod("configs.base"), algorithm, name)
    cfg = mod("configs.fedsr_mlp").CONFIG
    rng = np.random.default_rng(fl.seed)
    clients = mod("data.pipeline").make_clients(
        train, scheme=fl.partition, num_devices=fl.num_devices, rng=rng,
        xi=fl.xi, alpha=fl.alpha)
    clients = mod("core.adversary").AdversaryState(
        fl.adversary, fl.num_devices).poison_clients(clients, cfg.num_classes)
    trainer = (mod("core.local").LocalTrainer(cfg, fl) if pkg == "repro"
               else mod("core.local").LocalTrainer(cfg, fl, "cpu"))
    planner = mod("core.algorithms").make_algorithm(algorithm, trainer,
                                                    clients, fl)
    return planner.plan_schedule(0, ROUNDS, rng, {})


def gaps(seeds, draws: int, stop_after: int) -> None:
    """Each run's sensitivity to a rounding-size change of the initial
    weights and to a 1.03x learning rate, on the port's CPU: its model
    after ``stop_after`` rounds."""
    import torch

    import repro_torch.configs.base as base
    from repro_torch.configs.fedsr_mlp import CONFIG
    from repro_torch.core.executor import run_experiment
    from repro_torch.models.small import init_small_model, params_to_numpy

    def final(fl, init):
        return run_experiment(task="mnist_like", model_cfg=CONFIG, fl=fl,
                              eval_every=ROUNDS, init_params=init,
                              device="cpu", stop_after=stop_after)

    def gap(a, b) -> float:
        accs.append(abs(a.final_accuracy - b.final_accuracy))
        a, b = a.final_model, b.final_model
        return max(float((a[k] - b[k]).abs().max()) for k in a)

    for seed in seeds:
        init = params_to_numpy(init_small_model(
            torch.Generator().manual_seed(seed), CONFIG, torch.device("cpu")))
        for algorithm, name in RUNS:
            fl = phase_fl(base, algorithm, name)
            ref = final(fl, init)
            accs = []
            signs = np.random.default_rng(seed + 100)
            moved = [gap(final(fl, {k: (v * (1 + 1e-7 * signs.choice(
                [-1.0, 1.0], size=v.shape))).astype(np.float32)
                for k, v in init.items()}), ref) for _ in range(draws)]
            control = gap(final(dataclasses.replace(
                fl, init_lr=fl.init_lr * 1.03), init), ref)
            print(f"gaps: {algorithm}/{name} seed {seed}, the model after "
                  f"round {stop_after}: initial weights "
                  f"moved by a relative 1e-7: "
                  + ", ".join(f"{g:.3e}" for g in moved)
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

    from repro.data.synthetic import make_task as ref_make_task
    from repro_torch.data.synthetic import make_task

    ref_train, _ = ref_make_task("mnist_like", seed=0)
    port_train, _ = make_task("mnist_like", seed=0)
    table, batched, bad = {}, {}, 0
    for algorithm, name in RUNS:
        ref = plan_block("repro", algorithm, name, ref_train)
        port = plan_block("repro_torch", algorithm, name, port_train)
        table[algorithm, name] = literal(ref)
        if literal(port) != table[algorithm, name]:
            bad += 1
            print(f"{algorithm}/{name}: the port plans "
                  f"{literal(port)}  DIFFERS", flush=True)
        if (algorithm, name) in BATCHED:
            batched[algorithm, name] = engine_counts([(0, ref)], "batched")
    print("SCENARIO_LITERALS = {")
    for (algorithm, name), (steps, comm, sim, n) in table.items():
        items = [f'"{k}": {v}' for k, v in comm.items()]
        half = (len(items) + 1) // 2
        print(f'    ("{algorithm}", "{name}"): (\n        {steps}, '
              f'{{{", ".join(items[:half])},\n         '
              f'{", ".join(items[half:])}}}, {sim!r}, {n}),')
    print("}")
    print("SCENARIO_BATCHED = {" + ", ".join(
        f'("{a}", "{k}"): {n}' for (a, k), n in batched.items()) + "}")
    if args.check:
        import chip_smoke

        for got, want, what in (
                (chip_smoke.SCENARIO_LITERALS, table, "SCENARIO_LITERALS"),
                (chip_smoke.SCENARIO_BATCHED, batched, "SCENARIO_BATCHED")):
            same = got == want
            bad += not same
            print(f"chip_smoke.{what} {'equals' if same else 'DIFFERS from'}"
                  f" the reference's", flush=True)
    if args.gaps:
        gaps(args.seeds, args.draws, args.stop_after)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
