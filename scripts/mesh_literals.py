#!/usr/bin/env python3
"""The literals of ``chip_smoke.py``'s phase 3k, from the JAX package's
runs on the CPU: for each of the phase's runs (FedSR on the fused engine
with ``mesh_data_axis="data"`` and FedAvg on the sharded engine, on a
1-device mesh and on 8 faked host devices), the largest shard of the fleet
(``N_max``), and the run's ``h2d_bytes``, ``peak_device_bytes`` and
dispatches as the reference's ``run_experiment`` meters them.

    PYTHONPATH=src python scripts/mesh_literals.py [--check]

The phase's settings are phase 3's path (the paper MLP at full width,
``mnist_like`` at 2,000/400 images, pathological xi=2, K=20, M=5, R=5,
batch 32, ``use_fused_sgd=True``, seed 0; E=1 for FedSR, 5 for FedAvg),
2 rounds in one block.
Under a mesh the fused engine's plane pads every shard to ``N_max`` and
its 20 shards to a mesh multiple (20 on one device, 24 on 8), and every
lane stack is ghost-padded (FedSR's 5 rings to 8 lanes, FedAvg's 20 to
24), which the meters read. The runs on one device go in this process;
those on 8 devices in a child process of this script with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``. The script prints
the literals as the Python table ``chip_smoke.py`` holds
(``MESH_LITERALS``) and exits non-zero if the port's planes and meters,
computed without training (``N_max``, the plane's ``nbytes``), differ
where it can compute them; ``--check`` also compares them with the table
in ``chip_smoke.py``. About two minutes on a CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import MESH_RUNS  # noqa: E402


def phase_fl(base, algorithm: str, engine: str, axis):
    """Phase 3k's FLConfig of one run (``chip_smoke.mesh_fl``) in the
    package whose config module is ``base``."""
    return base.FLConfig(
        algorithm=algorithm, num_devices=20, num_edges=5, ring_rounds=5,
        local_epochs=5 if algorithm == "fedavg" else 1, batch_size=32,
        rounds=2, partition="pathological",
        xi=2, engine=engine, mesh_data_axis=axis, use_fused_sgd=True,
        seed=0)


def reference_literals() -> dict:
    """``{(algorithm, engine, axis): (n_max, h2d, peak, dispatches)}`` of
    the reference's runs on the devices this process sees."""
    import numpy as np

    import repro.configs.base as base
    import repro.core.executor as executor
    from repro.configs.fedsr_mlp import CONFIG
    from repro.data.pipeline import make_clients
    from repro.data.synthetic import make_task

    train, test = make_task("mnist_like", seed=0)
    clients = make_clients(train, scheme="pathological", num_devices=20,
                           rng=np.random.default_rng(0), xi=2)
    n_max = max(len(c) for c in clients)
    made = []

    class Recorded(executor.LocalTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    executor.LocalTrainer = Recorded
    out = {}
    for algorithm, engine, axis in MESH_RUNS:
        fl = phase_fl(base, algorithm, engine, axis)
        res = executor.run_experiment(task="mnist_like", model_cfg=CONFIG,
                                      fl=fl, eval_every=2, train=train,
                                      test=test)
        tr = made[-1]
        out[algorithm, engine, axis] = (n_max, int(tr.h2d_bytes),
                                        int(res.peak_device_bytes),
                                        int(tr.dispatches))
    return out


def port_planes(mesh_size: int) -> dict:
    """The port's ``N_max`` and fleet-plane ``nbytes`` under a sim mesh of
    ``mesh_size`` CPU entries, built as the fused engine builds it."""
    import numpy as np
    import torch

    import repro_torch.launch.mesh as mesh
    from repro_torch.data.pipeline import DeviceDataPlane, make_clients
    from repro_torch.data.synthetic import make_task

    train, _ = make_task("mnist_like", seed=0)
    clients = make_clients(train, scheme="pathological", num_devices=20,
                           rng=np.random.default_rng(0), xi=2)
    mesh.visible_devices = lambda device=None: [torch.device("cpu")] * (
        mesh_size)
    plane = DeviceDataPlane(clients, torch.device("cpu"),
                            mesh=mesh.make_sim_mesh(20))
    return {"n_max": max(len(c) for c in clients), "nbytes": plane.nbytes}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="also compare with chip_smoke.MESH_LITERALS")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps([[list(k), v] for k, v in
                          reference_literals().items()]))
        return 0
    import jax

    table = {(*k, len(jax.devices())): v
             for k, v in reference_literals().items()}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    child = subprocess.run([sys.executable, __file__, "--child"], env=env,
                           capture_output=True, text=True, check=True)
    for k, v in json.loads(child.stdout.strip().splitlines()[-1]):
        table[(*k, 8)] = tuple(v)
    print("MESH_LITERALS = {")
    for k in sorted(table, key=lambda k: (k[3], k[0])):
        print(f"    {k!r}: {table[k]!r},")
    print("}")
    bad = []
    for size in (1, 8):
        planes = port_planes(size)
        for (algorithm, engine, _, n), (n_max, _, peak, _) in \
                table.items():
            if n != size:
                continue
            if planes["n_max"] != n_max:
                bad.append(f"N_max {planes['n_max']} against {n_max}")
            if engine == "fused" and planes["nbytes"] != peak:
                bad.append(f"{algorithm} on {size}: plane {planes['nbytes']}"
                           f" bytes, peak {peak}")
    if args.check:
        from chip_smoke import MESH_LITERALS

        if MESH_LITERALS != table:
            bad.append("chip_smoke.MESH_LITERALS differs")
    for b in bad:
        print(f"[FAIL] {b}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
