"""Shared helpers of the PyTorch-port parity tests (NOT a test module).

Every port test runs the JAX package (the reference, ``repro``) and its
twin in ``repro_torch`` on the same inputs — configs built field for field
in both packages, data and weights made from a seed with numpy — and
compares what they return, exactly for host-side integer/plan data and
within a stated tolerance for float math. Data crosses between the two
packages only as numpy arrays.

Imported at collection time, so in every pytest-xdist worker, it sets
torch's intra-op pool to one thread there: each worker would otherwise
open a pool as wide as the machine, and the workers together
oversubscribe the cores many times over.
"""
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

if os.environ.get("PYTEST_XDIST_WORKER"):
    try:
        import torch
    except ImportError:     # the reference-only CI has no torch
        pass
    else:
        torch.set_num_threads(1)

# A CNN run crosses ReLU and max-pool kinks millions of times, so the last
# bit of a forward value can switch which side of a kink an element lands
# on; that moves one step's update at one position by about lr / B
# (0.01 / 8 = 1.25e-3 in the tests' narrow runs) and the run goes on from
# there. A 1e-7 relative change of the initial weights moves the port's OWN
# 4-round narrow FedSR run (test_torch_cnn's configuration) by up to
# 1.1e-3 (three initial models, three draws each, on the CPU:
# scripts/cnn_sensitivity.py). So whole CNN runs are held at a few such
# switches; one step is held at 1e-5.
CNN_RUN_ATOL = 5e-3

# the narrow paper MLP and the small FL setting of the whole-run tests
SMALL = {"mlp_hidden": (32, 32)}


def fl_kwargs(**kw) -> dict:
    """FLConfig fields of the tests' small FedSR runs, with overrides."""
    base = {"algorithm": "fedsr", "engine": "fused", "num_devices": 4,
            "num_edges": 2, "ring_rounds": 2, "rounds": 4, "batch_size": 8,
            "partition": "pathological"}
    base.update(kw)
    return base


def mnist_tasks(train_per_class=20, test_per_class=10):
    """``((ref_train, ref_test), (port_train, port_test))`` of
    ``mnist_like`` at a small size, made by each package."""
    from repro.data.synthetic import make_task as ref_make_task
    from repro_torch.data.synthetic import make_task

    return (ref_make_task("mnist_like", train_per_class=train_per_class,
                          test_per_class=test_per_class),
            make_task("mnist_like", train_per_class=train_per_class,
                      test_per_class=test_per_class))


_SUB_CONFIGS = {"scenario": "ScenarioConfig", "adversary": "AdversaryConfig",
                "personalize": "PersonalizeConfig"}


def configs(model_overrides=None, **fl_kw):
    """``((ref_model, ref_fl), (port_model, port_fl))``: the paper MLP and
    one FLConfig, built with the same overrides in both packages (a
    ``scenario``, ``adversary`` or ``personalize`` given as a dict of
    fields, as each package's own sub-config)."""
    from repro.configs.base import FLConfig as RefFL
    from repro.configs.fedsr_mlp import CONFIG as REF_MLP
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.fedsr_mlp import CONFIG

    import repro.configs.base as ref_base
    import repro_torch.configs.base as port_base

    def fl(base, cls):
        # sub-configs given as dicts become each package's own
        kw = {k: (getattr(base, _SUB_CONFIGS[k])(**v)
                  if k in _SUB_CONFIGS and isinstance(v, dict) else v)
              for k, v in fl_kw.items()}
        return cls(**kw)

    mo = dict(model_overrides or {})
    return ((dataclasses.replace(REF_MLP, **mo), fl(ref_base, RefFL)),
            (dataclasses.replace(CONFIG, **mo), fl(port_base, FLConfig)))


def jax_init(ref_cfg, seed: int = 0) -> dict:
    """The reference's initial ``w_glob`` (``init_small_model`` from
    ``PRNGKey(seed)``, as its executor draws it) as numpy arrays."""
    import jax
    from repro.models.small import init_small_model

    return to_numpy(init_small_model(jax.random.PRNGKey(seed), ref_cfg))


def to_numpy(tree) -> dict:
    """A parameter dict of either package as float32 numpy arrays."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v, np.float32)
    return out


def assert_trees_close(a, b, *, atol: float, rtol: float = 0.0) -> None:
    a, b = to_numpy(a), to_numpy(b)
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=rtol,
                                   err_msg=f"leaf {k}")


def ref_run_recorded(monkeypatch, **kw):
    """The reference's ``run_experiment`` and the ``LocalTrainer`` it made
    (its meters are not in the reference's ``ExperimentResult``)."""
    import repro.core.executor as ref_executor

    made = []

    class Recorded(ref_executor.LocalTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    with monkeypatch.context() as m:
        m.setattr(ref_executor, "LocalTrainer", Recorded)
        res = ref_executor.run_experiment(**kw)
    return res, made[0]


def assert_histories_equal(ref, port, n_test: int) -> None:
    """Eval rounds, comm meters and learning rates equal; every accuracy
    the same count of correct test images (the two packages round the
    float32 mean differently, so one count can read an ulp apart)."""
    assert [r.round for r in ref.history] == [r.round for r in port.history]
    for a, b in zip(ref.history, port.history):
        assert round(a.accuracy * n_test) == round(b.accuracy * n_test), (
            a.round, a.accuracy, b.accuracy)
        assert a.comm == b.comm
        assert a.rounds == b.rounds
        assert np.float32(a.lr) == np.float32(b.lr)


def record_plans(monkeypatch, module):
    """Record ``(t0, schedule, RNG state after it)`` of every block that
    ``module``'s planners plan (``repro.core.algorithms`` or
    ``repro_torch.core.algorithms``)."""
    import copy
    import importlib

    base = importlib.import_module(module)._Planner
    seen = []
    orig = base.plan_schedule

    def plan_schedule(self, t0, n, rng, state):
        sched = orig(self, t0, n, rng, state)
        seen.append((t0, sched, copy.deepcopy(rng.bit_generator.state)))
        return sched

    monkeypatch.setattr(base, "plan_schedule", plan_schedule)
    return seen


def assert_schedules_equal(ref_sched, port_sched) -> None:
    """Two Schedules (one per package) hold identical plans: same ids,
    same batch-index arrays, same loss variants, shared and per-lane
    extras (``GLOBAL``/``StateRef`` sentinels by name), seeds,
    ``keep_locals`` and adversarial ``lane_scale``, same aggregation
    weights and reducer, comm records and simulated seconds."""
    assert ref_sched.comm == port_sched.comm
    assert len(ref_sched.plans) == len(port_sched.plans)
    for rp, pp in zip(ref_sched.plans, port_sched.plans):
        assert rp.comm == pp.comm
        assert rp.sim_seconds == pp.sim_seconds
        assert len(rp.groups) == len(pp.groups)
        for rg, pg in zip(rp.groups, pp.groups):
            assert rg.variant == pg.variant
            assert rg.seed == pg.seed
            # the sentinels are each package's own objects: compare names
            assert ({k: repr(v) for k, v in rg.shared_extras.items()}
                    == {k: repr(v) for k, v in pg.shared_extras.items()})
            assert ({k: repr(v) for k, v in rg.stacked_extras.items()}
                    == {k: repr(v) for k, v in pg.stacked_extras.items()})
            assert rg.keep_locals == pg.keep_locals
            assert rg.lane_scale == pg.lane_scale
            assert rg.agg.groups == pg.agg.groups
            assert rg.agg.lane_weights == pg.agg.lane_weights
            assert rg.agg.group_weights == pg.agg.group_weights
            assert ((rg.agg.reducer, rg.agg.trim_frac, rg.agg.krum_f)
                    == (pg.agg.reducer, pg.agg.trim_frac, pg.agg.krum_f))
            assert len(rg.hops) == len(pg.hops)
            for rh, ph in zip(rg.hops, pg.hops):
                assert rh.ids == ph.ids
                for a, b in zip(rh.plans, ph.plans):
                    assert (a is None) == (b is None)
                    if a is not None:
                        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the sim mesh (tests/test_torch_sharded.py): the parity matrix of
# engine="sharded" and mesh_data_axis, whose 8-entry half runs the
# reference in a subprocess on 8 faked host devices (``python
# tests/torch_parity.py mesh8 <out_dir>``)

# engine_parity's whole-run settings (K=8, two edges, rings of 4, two laps)
MESH_FL = {"num_devices": 8, "num_edges": 2, "rounds": 2, "ring_rounds": 2,
           "local_epochs": 1, "batch_size": 8, "momentum": 0.5,
           "partition": "dirichlet", "alpha": 0.5, "seed": 3}
MESH_TASK = {"train_per_class": 10, "test_per_class": 2, "seed": 0}
# each mode's FLConfig fields, and those of the same run without a mesh
MESH_MODES = {"sharded": {"engine": "sharded"},
              "fused_mesh": {"engine": "fused", "mesh_data_axis": "data"}}
UNMESHED = {"sharded": {"engine": "batched"}, "fused_mesh": {"engine": "fused"}}


def mesh_cases():
    """``(name, algorithm, fl overrides, eval_every)`` of the matrix:
    ``engine_parity.CASES`` (its seven algorithms and the two
    participation-0.75 cases, whose cohorts of 6 and rings of 4 and 2 do
    not divide an 8-entry mesh) and Centralized, in one block."""
    from engine_parity import CASES

    out = [("-".join([a] + [f"{k}{v}" for k, v in ov.items()]), a, ov, 2)
           for a, ov in CASES]
    return out + [("centralized", "centralized", {}, 2)]


# the 8-entry matrix's further cases (Krum is left out: its exact ties,
# ROADMAP C1, pick a lane by rounding): (name, algorithm, mode, fl
# overrides, eval_every)
MESH8_EXTRA = [
    ("drop30", "fedsr", "fused_mesh", {"scenario": {"drop_rate": 0.3}}, 2),
    ("median", "fedavg", "sharded",
     {"reducer": "median", "adversary": {"frac": 0.25}}, 2),
    ("clip", "fedsr", "fused_mesh", {"dp_clip": 2.5}, 2),
    ("moon_host", "moon", "fused_mesh",
     {"store": "host", "prefetch": 1, "participation": 0.5, "rounds": 3}, 1),
    ("head", "fedavg", "fused_mesh",
     {"personalize": {"epochs": 1, "lr": 0.05, "mode": "head",
                      "eval_per_client": 16}}, 2),
]


def mesh8_cases():
    """Every run of the 8-entry matrix: ``(name, algorithm, mode, fl
    overrides, eval_every)``."""
    return ([(n, a, m, ov, ev) for n, a, ov, ev in mesh_cases()
             for m in MESH_MODES] + MESH8_EXTRA)


def mesh_configs(algorithm, mode, overrides, meshed=True):
    """Both packages' (model, FLConfig) of one matrix run, with the mesh of
    ``mode`` or (``meshed=False``) the same run without it."""
    engine = (MESH_MODES if meshed else UNMESHED)[mode]
    return configs(SMALL, **{**MESH_FL, "algorithm": algorithm, **engine,
                             **overrides})


def _canon(x):
    """A JSON-able canonical form of plan data in either package: arrays by
    dtype, shape and digest, floats by repr, sentinels by name."""
    if x is None or isinstance(x, (bool, int, str)):
        return x
    if isinstance(x, np.generic):
        return _canon(x.item())
    if isinstance(x, float):
        return repr(x)
    if isinstance(x, np.ndarray):
        return [str(x.dtype), list(x.shape),
                hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()]
    if isinstance(x, dict):
        return [[str(k), _canon(x[k])] for k in sorted(x)]
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    return repr(x)


def schedule_digest(sched):
    """One digest of everything ``assert_schedules_equal`` compares, so a
    schedule planned in another process can be held against this one's."""
    if sched is None:
        return None
    plans = []
    for p in sched.plans:
        groups = []
        for g in p.groups:
            a = g.agg
            groups.append([
                g.variant, g.seed, g.shared_extras, g.stacked_extras,
                g.keep_locals, g.lane_scale, a.groups, a.lane_weights,
                a.group_weights, a.reducer, a.trim_frac, a.krum_f,
                [[h.ids, h.plans] for h in g.hops]])
        plans.append([p.comm, p.sim_seconds, groups])
    blob = json.dumps(_canon([sched.comm, plans]))
    return hashlib.sha256(blob.encode()).hexdigest()


def run_summary(res, blocks, h2d: int, dispatches: int) -> dict:
    """What the parity target compares exactly of one whole run, as JSON:
    eval records, meters, and each block's start, plan digest and RNG
    state after planning it."""
    out = {"history": [[r.round, float(r.accuracy), _canon(r.comm),
                        r.rounds, float(np.float32(r.lr))]
                       for r in res.history],
           "h2d": int(h2d), "dispatches": int(dispatches),
           "peak": int(res.peak_device_bytes),
           "blocks": [[t, schedule_digest(s), rng] for t, s, rng in blocks]}
    if res.personalized_accuracy is not None:
        out["pers"] = [float(res.personalized_accuracy),
                       float(res.global_client_accuracy)]
    return out


def assert_summaries_equal(ref: dict, port: dict, n_test: int) -> None:
    """Two ``run_summary``s: blocks (plans, RNG), comm, learning rates and
    meters equal, each accuracy the same count of test images."""
    assert [b[0] for b in ref["blocks"]] == [b[0] for b in port["blocks"]]
    for a, b in zip(ref["blocks"], port["blocks"]):
        assert a[1] == b[1], ("plans differ", a[0])
        assert json.loads(json.dumps(a[2])) == json.loads(json.dumps(b[2]))
    assert len(ref["history"]) == len(port["history"])
    for a, b in zip(ref["history"], port["history"]):
        assert a[0] == b[0] and a[2:] == b[2:], (a, b)
        assert round(a[1] * n_test) == round(b[1] * n_test), (a, b)
    for k in ("h2d", "dispatches", "peak"):
        assert ref[k] == port[k], (k, ref[k], port[k])
    if "pers" in ref:
        np.testing.assert_allclose(port["pers"], ref["pers"], atol=1e-6)


def reference_trainer(cache: dict, rm, rfl):
    """One reference ``LocalTrainer`` for every run that reads the same
    trainer fields, its meters zeroed: shared, its compiled steps stay
    warm across runs."""
    from repro.core.local import LocalTrainer

    key = tuple(getattr(rfl, f) for f in (
        "batch_size", "dp_clip", "dp_noise_mult", "dp_seed", "momentum",
        "moon_tau", "mu", "use_fused_sgd"))
    if key not in cache:
        cache[key] = LocalTrainer(rm, rfl)
    tr = cache[key]
    tr.h2d_bytes = tr.dispatches = 0
    return tr


def reference_mesh_run(cache: dict, rm, rfl, train, test, eval_every):
    """The reference's ``run_experiment`` of one matrix run on a shared
    trainer: ``(result, run_summary)``."""
    import copy

    import repro.core.algorithms as ref_algorithms
    import repro.core.executor as ref_executor

    tr = reference_trainer(cache, rm, rfl)
    planner = ref_algorithms._Planner
    orig_plan, orig_trainer = planner.plan_schedule, ref_executor.LocalTrainer
    blocks = []

    def plan_schedule(self, t0, n, rng, state):
        sched = orig_plan(self, t0, n, rng, state)
        blocks.append((t0, sched, copy.deepcopy(rng.bit_generator.state)))
        return sched

    planner.plan_schedule = plan_schedule
    ref_executor.LocalTrainer = lambda *a, **k: tr
    try:
        res = ref_executor.run_experiment(
            task="mnist_like", model_cfg=rm, fl=rfl, train=train, test=test,
            eval_every=eval_every)
    finally:
        planner.plan_schedule = orig_plan
        ref_executor.LocalTrainer = orig_trainer
    return res, run_summary(res, blocks, tr.h2d_bytes, tr.dispatches)


# the reference's 8-entry mesh plane: a fleet of 5 shards of sizes 3..11,
# whose rows round up to 8 (``mesh8_plane_clients``)
MESH8_PLANE_SIZES = (3, 11, 6, 9, 4)


def mesh8_plane_clients(pkg: str):
    """``MESH8_PLANE_SIZES``'s shards as ``pkg``'s ``ClientData``."""
    import importlib

    ClientData = importlib.import_module(f"{pkg}.data.pipeline").ClientData
    rng = np.random.default_rng(5)
    return [ClientData(i, rng.random((n, 4, 4, 1), dtype=np.float32),
                       rng.integers(0, 10, n))
            for i, n in enumerate(MESH8_PLANE_SIZES)]


def plane_summary(plane) -> dict:
    """A data plane of either package: its bytes and its arrays' digests."""
    arrays = {}
    for name in ("images", "labels", "offsets"):
        a = getattr(plane, name)
        a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
        arrays[name] = _canon(a)
    return {"nbytes": int(plane.nbytes),
            "real_nbytes": int(plane.real_nbytes), **arrays}


def _mesh8_payload(out_dir: str) -> None:
    """The subprocess: every run of ``mesh8_cases`` by the reference on 8
    faked host devices (``<out_dir>/<name>-<mode>.npz`` holds its final
    weights, and its personalized fleet under ``fleet/``), the meters in
    ``<out_dir>/mesh8.json``, with the reference's planes on the 8-device
    mesh."""
    import jax

    from repro.data.pipeline import DeviceDataPlane
    from repro.data.synthetic import make_task
    from repro.launch.mesh import make_sim_mesh

    # one program at a time: the 8 replicas of a program hold 8 threads of
    # XLA's CPU pool while they wait in its all-reduce, so a second program
    # in flight can leave the rendezvous short of threads
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    train, test = make_task("mnist_like", **MESH_TASK)
    out = {"ndev": len(jax.devices()), "runs": {}, "planes": {}}
    cache = {}
    for name, algorithm, mode, ov, eval_every in mesh8_cases():
        (rm, rfl), _ = mesh_configs(algorithm, mode, ov)
        res, summary = reference_mesh_run(cache, rm, rfl, train, test,
                                          eval_every)
        out["runs"][f"{name}-{mode}"] = summary
        arrays = dict(to_numpy(res.final_model))
        if res.personalized_fleet is not None:
            arrays.update({f"fleet/{k}": v for k, v in
                           to_numpy(res.personalized_fleet).items()})
        np.savez(os.path.join(out_dir, f"{name}-{mode}.npz"), **arrays)
    clients = mesh8_plane_clients("repro")
    mesh = make_sim_mesh()
    out["planes"]["fleet"] = plane_summary(DeviceDataPlane(clients, mesh=mesh))
    ids = np.asarray([4, 1, 3])
    out["planes"]["cohort"] = plane_summary(DeviceDataPlane(
        [clients[i] for i in ids], mesh=mesh, client_ids=ids, fleet_size=5))
    with open(os.path.join(out_dir, "mesh8.json"), "w") as f:
        json.dump(out, f)


# XLA's in-process collectives abort when a replica misses the rendezvous
# for 40 s: what the reference's 8-replica programs print when the CPU
# pool ran out of threads for them
RENDEZVOUS_ABORT = "threads to join the rendezvous"


def start_mesh8_reference(out_dir: str, ndev: int = 8):
    """Start the reference's 8-entry matrix in a subprocess with ``ndev``
    faked host devices; ``finish_mesh8_reference`` waits for it. Each
    replica's matrix products run on its own thread
    (``xla_cpu_multi_thread_eigen=false``), so no replica waits on helper
    tasks queued behind the replicas that hold the pool's threads."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_")}
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={ndev} "
                        "--xla_cpu_multi_thread_eigen=false")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = (os.path.join(root, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "mesh8", out_dir],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def finish_mesh8_reference(proc, out_dir: str, timeout: float = 600):
    """Wait for ``start_mesh8_reference``'s subprocess: ``(meters,
    weights by run)``. A subprocess that XLA aborted at a rendezvous (the
    reference's runtime, not a result) is started once more and waited
    for."""
    for attempt in range(2):
        try:
            _, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        if proc.returncode == 0 or RENDEZVOUS_ABORT not in err or attempt:
            break
        proc = start_mesh8_reference(out_dir)
    assert proc.returncode == 0, err[-3000:]
    with open(os.path.join(out_dir, "mesh8.json")) as f:
        meters = json.load(f)
    weights = {}
    for key in meters["runs"]:
        with np.load(os.path.join(out_dir, f"{key}.npz")) as z:
            weights[key] = {k: z[k] for k in z.files}
    return meters, weights


if __name__ == "__main__" and sys.argv[1:2] == ["mesh8"]:
    _mesh8_payload(sys.argv[2])
