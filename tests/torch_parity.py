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
import os

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


_SUB_CONFIGS = {"scenario": "ScenarioConfig", "adversary": "AdversaryConfig"}


def configs(model_overrides=None, **fl_kw):
    """``((ref_model, ref_fl), (port_model, port_fl))``: the paper MLP and
    one FLConfig, built with the same overrides in both packages (a
    ``scenario`` or ``adversary`` given as a dict of fields, as each
    package's own sub-config)."""
    from repro.configs.base import FLConfig as RefFL
    from repro.configs.fedsr_mlp import CONFIG as REF_MLP
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.fedsr_mlp import CONFIG

    import repro.configs.base as ref_base
    import repro_torch.configs.base as port_base

    def fl(base, cls):
        # scenario= and adversary= given as dicts become each package's
        # own sub-config
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
