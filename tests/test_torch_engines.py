"""The port's per-round engines, sequential and batched, against the JAX
package's, and against the port's own fused engine.

* Host side, exactly: ``stack_plans`` and ``stack_client_batches`` give
  the reference's arrays byte for byte (ring tails, short plans, ghost
  rows).
* One client visit: ``LocalTrainer.train`` from the reference's weights and
  plan, ``use_fused_sgd`` off and on, within 1e-5 after one step and after
  the whole visit, with the reference's meters; the same with FedProx's
  loss against the reference's ``variant="prox"``.
* Whole runs of a narrow MLP through ``run_experiment`` from the
  reference's initial weights, for FedSR, FedAvg, FedProx, Ring and
  HierFAVG under both engines, ``use_fused_sgd`` off and on: eval rounds,
  accuracies, comm
  meters, learning rates and ``peak_device_bytes`` equal, the trainer's
  ``h2d_bytes`` and ``dispatches`` equal to the reference trainer's, final
  weights within 1e-4; one narrow CNN run per engine within
  ``CNN_RUN_ATOL``.
* Inside the port: batched bit-equal to fused, sequential within 1e-6 of
  fused (its unmasked update and its ordered two-level reduce round
  otherwise, as the reference's own sequential engine does against its
  fused one), HierFAVG's seeded edge iterations included; the block size
  changes no bit of either engine's result.
* The plan IR's seeding rules.
* A run checkpointed by the reference's sequential engine resumes in the
  port's; ``FLConfig()`` as it stands runs and matches the reference.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from torch_parity import (
    CNN_RUN_ATOL, SMALL, assert_trees_close, configs, fl_kwargs, jax_init,
    mnist_tasks,
)
from torch_parity import assert_histories_equal as _assert_histories_equal
from torch_parity import ref_run_recorded as _ref_run

CPU = torch.device("cpu")
ENGINES = ("sequential", "batched")


def _port_run(pm, pfl, ptr, pte, init, **kw):
    from repro_torch.core.executor import run_experiment

    return run_experiment(task="mnist_like", model_cfg=pm, fl=pfl,
                          train=ptr, test=pte, init_params=init,
                          device="cpu", **kw)


def _flat(model) -> torch.Tensor:
    return torch.cat([v.reshape(-1) for _, v in sorted(model.items())])


# ---------------------------------------------------------------------------
# host side, exactly


def _clients(pkg, sizes=(13, 8, 5, 21)):
    from importlib import import_module

    ClientData = import_module(f"{pkg}.data.pipeline").ClientData
    rng = np.random.default_rng(4)
    out = []
    for i, n in enumerate(sizes):
        out.append(ClientData(i, rng.random((n, 3, 3, 2), dtype=np.float32),
                              rng.integers(0, 10, n).astype(np.int32)))
    return out


@pytest.mark.parametrize("pad_to,width,tail", [
    (None, None, False), (6, None, True), (None, 4, True), (4, 4, False)])
def test_stack_plans_are_the_reference_bytes(pad_to, width, tail):
    """Plans of 2, 1 and 3 epochs (short plans pad by repeating their first
    batch), a ``None`` ring tail (an all-invalid row), ghost rows and an
    explicit batch width: the same arrays, dtypes and bytes."""
    from repro.data.pipeline import plan_epoch_indices as ref_plan
    from repro.data.pipeline import stack_plans as ref_stack
    from repro_torch.data.pipeline import plan_epoch_indices, stack_plans

    rc, pc = _clients("repro"), _clients("repro_torch")
    rr, pr = np.random.default_rng(9), np.random.default_rng(9)
    ref_plans = [ref_plan(c, 4, e, rr) for c, e in zip(rc, (2, 1, 3, 1))]
    port_plans = [plan_epoch_indices(c, 4, e, pr)
                  for c, e in zip(pc, (2, 1, 3, 1))]
    if tail:
        ref_plans[1] = port_plans[1] = None
    ra, rv = ref_stack(rc, ref_plans, pad_to=pad_to, width=width)
    pa, pv = stack_plans(pc, port_plans, pad_to=pad_to, width=width)
    assert sorted(ra) == sorted(pa)
    for k in ra:
        assert ra[k].dtype == pa[k].dtype and ra[k].shape == pa[k].shape, k
        assert ra[k].tobytes() == pa[k].tobytes(), k
    assert rv.dtype == pv.dtype and rv.tobytes() == pv.tobytes()
    assert pv.shape[0] == max(len(pc), pad_to or 0)
    assert pv[1].any() != tail


def test_stack_client_batches_draws_as_the_reference():
    from repro.data.pipeline import stack_client_batches as ref_stack
    from repro_torch.data.pipeline import stack_client_batches

    rr, pr = np.random.default_rng(2), np.random.default_rng(2)
    ra, rv = ref_stack(_clients("repro"), 4, 2, rr, pad_to=5)
    pa, pv = stack_client_batches(_clients("repro_torch"), 4, 2, pr,
                                  pad_to=5)
    for k in ra:
        assert ra[k].tobytes() == pa[k].tobytes(), k
    assert rv.tobytes() == pv.tobytes()
    assert rr.bit_generator.state == pr.bit_generator.state


# ---------------------------------------------------------------------------
# one client visit


def _visit_setup(use_fused_sgd):
    from repro.core.local import LocalTrainer as RefTrainer
    from repro.data.pipeline import make_clients as ref_make_clients
    from repro_torch.core.local import LocalTrainer
    from repro_torch.data.pipeline import make_clients

    (rm, rfl), (pm, pfl) = configs(SMALL, **fl_kwargs(
        use_fused_sgd=use_fused_sgd, batch_size=6, engine="sequential"))
    (rtr, _), (ptr, _) = mnist_tasks()
    rc = ref_make_clients(rtr, scheme="pathological", num_devices=4,
                          rng=np.random.default_rng(0))
    pc = make_clients(ptr, scheme="pathological", num_devices=4,
                      rng=np.random.default_rng(0))
    return RefTrainer(rm, rfl), LocalTrainer(pm, pfl, CPU), rc[1], pc[1], rm


@pytest.mark.parametrize("use_fused_sgd", [False, True])
@pytest.mark.parametrize("steps", [1, None])
def test_one_visit_matches_reference(use_fused_sgd, steps):
    """``train`` from the same weights over the same plan — its first step,
    then the whole two-epoch visit: within 1e-5, the caller's weights left
    as they were, and the reference's meters (one dispatch and one batch of
    H2D bytes a step)."""
    from repro.data.pipeline import plan_epoch_indices as ref_plan
    from repro_torch.models.small import params_from_numpy
    from repro_torch.utils.tree import ravel_params, unravel

    ref_tr, tr, rclient, pclient, rm = _visit_setup(use_fused_sgd)
    plan = ref_plan(rclient, 6, 2, np.random.default_rng(1))[:steps]
    w0 = jax_init(rm, seed=3)
    want = ref_tr.train(jax.tree.map(jnp.asarray, w0), rclient, lr=0.05,
                        plan=plan)
    params = params_from_numpy(w0, CPU)
    w = ravel_params(params)
    before = w.clone()
    got = tr.train(w, pclient, lr=0.05, plan=plan)
    assert torch.equal(w, before)
    assert got.shape == w.shape
    assert_trees_close(unravel(got, tr.layout), want, atol=1e-5)
    assert tr.dispatches == ref_tr.dispatches == plan.shape[0]
    assert tr.h2d_bytes == ref_tr.h2d_bytes > 0


@pytest.mark.parametrize("use_fused_sgd", [False, True])
def test_one_prox_visit_matches_reference(use_fused_sgd):
    """``train`` with FedProx's loss (``variant="prox"``, the anchor a
    third model) over the whole two-epoch visit: within 1e-5 of the
    reference's ``train(variant="prox", anchor=...)``, and away from the
    plain visit by far more than that."""
    from repro.data.pipeline import plan_epoch_indices as ref_plan
    from repro_torch.models.small import params_from_numpy
    from repro_torch.utils.tree import ravel_params, unravel

    ref_tr, tr, rclient, pclient, rm = _visit_setup(use_fused_sgd)
    plan = ref_plan(rclient, 6, 2, np.random.default_rng(1))
    w0, anchor = jax_init(rm, seed=3), jax_init(rm, seed=4)
    want = ref_tr.train(jax.tree.map(jnp.asarray, w0), rclient, lr=0.05,
                        plan=plan, variant="prox",
                        anchor=jax.tree.map(jnp.asarray, anchor))
    w = ravel_params(params_from_numpy(w0, CPU))
    a = ravel_params(params_from_numpy(anchor, CPU))
    got = tr.train(w, pclient, lr=0.05, plan=plan, variant="prox", anchor=a)
    assert_trees_close(unravel(got, tr.layout), want, atol=1e-5)
    plain = tr.train(w, pclient, lr=0.05, plan=plan)
    assert float((got - plain).abs().max()) > 100 * 1e-5
    with pytest.raises(ValueError, match="anchor="):
        tr.train(w, pclient, lr=0.05, plan=plan, variant="prox")
    # MOON's loss reads the global model and the client's previous one
    with pytest.raises(ValueError, match="w_glob="):
        tr.train(w, pclient, lr=0.05, plan=plan, variant="moon")


def test_one_visit_draws_its_plan_as_the_reference():
    """The ``epochs=``/``rng=`` form draws the plan with the planners'
    calls: the same weights and the same generator state after."""
    from repro_torch.models.small import params_from_numpy
    from repro_torch.utils.tree import ravel_params, unravel

    ref_tr, tr, rclient, pclient, rm = _visit_setup(True)
    w0 = jax_init(rm, seed=3)
    rr, pr = np.random.default_rng(6), np.random.default_rng(6)
    want = ref_tr.train(jax.tree.map(jnp.asarray, w0), rclient, lr=0.05,
                        epochs=2, rng=rr)
    got = tr.train(ravel_params(params_from_numpy(w0, CPU)), pclient,
                   lr=0.05, epochs=2, rng=pr)
    assert rr.bit_generator.state == pr.bit_generator.state
    assert_trees_close(unravel(got, tr.layout), want, atol=1e-5)
    assert tr.dispatches == ref_tr.dispatches
    with pytest.raises(ValueError, match="plan="):
        tr.train(got, pclient, lr=0.05)


# ---------------------------------------------------------------------------
# whole runs against the reference


@pytest.mark.parametrize("use_fused_sgd", [False, True])
@pytest.mark.parametrize("algorithm", ["fedsr", "fedavg", "ring", "fedprox",
                                       "hieravg"])
@pytest.mark.parametrize("engine", ENGINES)
def test_whole_run_matches_reference(monkeypatch, engine, algorithm,
                                     use_fused_sgd):
    """Participation 0.75 (FedSR draws uneven rings: ring-tail hops; FedAvg
    and FedProx cohorts of uneven step counts; HierFAVG's R=2 edge
    iterations, the second seeded), two blocks of two rounds."""
    (rm, rfl), (pm, pfl) = configs(SMALL, **fl_kwargs(
        algorithm=algorithm, engine=engine, use_fused_sgd=use_fused_sgd,
        participation=0.75))
    (rtr, rte), (ptr, pte) = mnist_tasks()
    ref, ref_tr = _ref_run(monkeypatch, task="mnist_like", model_cfg=rm,
                           fl=rfl, eval_every=2, train=rtr, test=rte)
    port = _port_run(pm, pfl, ptr, pte, jax_init(rm, rfl.seed), eval_every=2)
    _assert_histories_equal(ref, port, len(rte))
    assert ref.peak_device_bytes == port.peak_device_bytes == 0
    assert port.h2d_bytes == ref_tr.h2d_bytes > 0
    assert port.dispatches == ref_tr.dispatches > 2
    assert_trees_close(port.final_model, ref.final_model, atol=1e-4)


@pytest.mark.parametrize("engine", ENGINES)
def test_whole_cnn_run_matches_reference(monkeypatch, engine):
    import repro.configs.fedsr_cnn as ref_cnn
    import repro_torch.configs.fedsr_cnn as port_cnn
    from repro.configs.base import FLConfig as RefFL
    from repro.data.synthetic import make_task as ref_make_task
    from repro_torch.configs.base import FLConfig
    from repro_torch.data.synthetic import make_task

    narrow = {"cnn_channels": (8, 16, 16)}
    rm = dataclasses.replace(ref_cnn.CONFIG, **narrow)
    pm = dataclasses.replace(port_cnn.CONFIG, **narrow)
    kw = fl_kwargs(engine=engine, use_fused_sgd=True, ring_rounds=1,
                   rounds=2, seed=11)
    data = dict(train_per_class=8, test_per_class=4, seed=11)
    rtr, rte = ref_make_task("cifar10_like", **data)
    ptr, pte = make_task("cifar10_like", **data)
    ref, ref_tr = _ref_run(monkeypatch, task="cifar10_like", model_cfg=rm,
                           fl=RefFL(**kw), train=rtr, test=rte)
    from repro_torch.core.executor import run_experiment
    port = run_experiment(task="cifar10_like", model_cfg=pm,
                          fl=FLConfig(**kw), train=ptr, test=pte,
                          init_params=jax_init(rm, 11), device="cpu")
    assert [r.round for r in ref.history] == [r.round for r in port.history]
    for a, b in zip(ref.history, port.history):
        assert abs(a.accuracy - b.accuracy) <= 1.0 / len(rte) + 1e-6
        assert a.comm == b.comm
    assert port.h2d_bytes == ref_tr.h2d_bytes
    assert port.dispatches == ref_tr.dispatches
    assert_trees_close(port.final_model, ref.final_model, atol=CNN_RUN_ATOL)


# ---------------------------------------------------------------------------
# the engines inside the port


def _engine_runs(algorithm, participation, use_fused_sgd, engines,
                 eval_every=2, **fl_kw):
    (rm, _), (pm, _) = configs(SMALL)
    _, (ptr, pte) = mnist_tasks()
    init = jax_init(rm, 0)
    out = {}
    for engine in engines:
        _, (_, pfl) = configs(SMALL, **fl_kwargs(
            algorithm=algorithm, engine=engine, participation=participation,
            use_fused_sgd=use_fused_sgd, **fl_kw))
        out[engine] = _port_run(pm, pfl, ptr, pte, init,
                                eval_every=eval_every)
    return out


@pytest.mark.parametrize("use_fused_sgd", [False, True])
@pytest.mark.parametrize("participation", [1.0, 0.75])
@pytest.mark.parametrize("algorithm", ["fedsr", "fedavg", "ring", "fedprox",
                                       "hieravg"])
def test_engines_agree_inside_the_port(algorithm, participation,
                                       use_fused_sgd):
    """``batched`` runs the fused engine's step and reduce on the same
    values: bit-equal. ``sequential`` rounds its update and its reduce
    otherwise: within 1e-6. Meters and histories agree; only the fused
    engine keeps a device-resident data plane."""
    _assert_engines_agree(_engine_runs(algorithm, participation,
                                       use_fused_sgd,
                                       ("fused", "batched", "sequential")))


@pytest.mark.parametrize("use_fused_sgd", [False, True])
@pytest.mark.parametrize("algorithm", ["fedprox", "hieravg"])
def test_engines_agree_on_partial_edges(algorithm, use_fused_sgd):
    """K=8 devices on M=2 edges at participation 0.5, R=3: FedProx's
    cohorts of 4, and HierFAVG's 2 of 4 devices an edge through two seeded
    edge iterations a round; the engines agree as above."""
    _assert_engines_agree(_engine_runs(
        algorithm, 0.5, use_fused_sgd, ("fused", "batched", "sequential"),
        num_devices=8, ring_rounds=3))


def _assert_engines_agree(runs) -> None:
    fused, batched, seq = (runs[e] for e in ("fused", "batched",
                                             "sequential"))
    for k in fused.final_model:
        assert torch.equal(batched.final_model[k], fused.final_model[k]), k
    err = float((_flat(seq.final_model) - _flat(fused.final_model))
                .abs().max())
    assert err <= 1e-6, err
    for res in (batched, seq):
        assert [(r.round, r.comm, r.lr) for r in res.history] == \
            [(r.round, r.comm, r.lr) for r in fused.history]
        assert res.peak_device_bytes == 0
    assert fused.peak_device_bytes > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_block_size_does_not_change_results(engine):
    """An eval every round and one every 4 rounds: bit-equal final models
    (the reference's chunked-parity contract)."""
    a = _engine_runs("fedsr", 0.75, True, (engine,), eval_every=1)[engine]
    b = _engine_runs("fedsr", 0.75, True, (engine,), eval_every=4)[engine]
    assert [r.round for r in a.history] == [1, 2, 3, 4]
    assert [r.round for r in b.history] == [4]
    for k in a.final_model:
        assert torch.equal(a.final_model[k], b.final_model[k]), k
    assert a.history[-1].comm == b.history[-1].comm


# ---------------------------------------------------------------------------
# resume across packages; the default config


def test_reference_sequential_checkpoint_resumes_in_the_port(tmp_path):
    from repro.core.executor import run_experiment as ref_run_experiment

    (rm, rfl), (pm, pfl) = configs(SMALL, **fl_kwargs(
        engine="sequential", participation=0.75))
    (rtr, rte), (ptr, pte) = mnist_tasks()
    kw = dict(task="mnist_like", model_cfg=rm, fl=rfl, eval_every=1,
              train=rtr, test=rte)
    full = ref_run_experiment(**kw)
    ckdir = str(tmp_path / "ck")
    ref_run_experiment(checkpoint_dir=ckdir, checkpoint_every=2,
                       stop_after=2, **kw)
    resumed = _port_run(pm, pfl, ptr, pte, None, eval_every=1,
                        checkpoint_dir=ckdir, checkpoint_every=2,
                        resume=True)
    _assert_histories_equal(full, resumed, len(rte))
    assert_trees_close(resumed.final_model, full.final_model, atol=1e-4)


def test_the_default_config_runs(monkeypatch):
    """``FLConfig()`` unchanged — the sequential engine, FedSR on K=20
    devices, M=5 rings, R=5 laps, the cosine schedule over 50 rounds — on a
    narrow MLP over a small ``mnist_like`` (one step a visit, 100 a round),
    stopped after round 20: it trains, and matches the reference."""
    from repro.configs.base import FLConfig as RefFL
    from repro_torch.configs.base import FLConfig

    assert FLConfig().engine == "sequential" and not FLConfig().use_fused_sgd
    (rm, _), (pm, _) = configs(SMALL)
    (rtr, rte), (ptr, pte) = mnist_tasks(train_per_class=10,
                                         test_per_class=10)
    kw = dict(eval_every=10, stop_after=20)
    ref, ref_tr = _ref_run(monkeypatch, task="mnist_like", model_cfg=rm,
                           fl=RefFL(), train=rtr, test=rte, **kw)
    port = _port_run(pm, FLConfig(), ptr, pte, jax_init(rm, 0), **kw)
    _assert_histories_equal(ref, port, len(rte))
    assert [r.round for r in port.history] == [10, 20]
    assert port.dispatches == ref_tr.dispatches == 20 * 100
    assert port.final_accuracy > 0.5
    assert_trees_close(port.final_model, ref.final_model, atol=1e-4)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("override", [{"mesh_data_axis": "data"}])
def test_unported_options_raise_under_the_new_engines(monkeypatch, engine,
                                                     override):
    """What stays unported of ``mesh_data_axis`` is a mesh over several
    distinct devices (ROADMAP A5.2): with two cards visible the batched
    engine raises; the sequential engine takes no mesh, as in the
    reference, and runs the plain run bit for bit."""
    import repro_torch.launch.mesh as mesh

    _, (pm, pfl) = configs(SMALL, **fl_kwargs(engine=engine, **override))
    _, (ptr, pte) = mnist_tasks(train_per_class=4, test_per_class=1)
    monkeypatch.setattr(mesh, "visible_devices", lambda device=None: [
        torch.device("cuda", 0), torch.device("cuda", 1)])
    if engine == "sequential":
        kw = dict(stop_after=1)
        got = _port_run(pm, pfl, ptr, pte, None, **kw)
        plain = _port_run(pm, dataclasses.replace(pfl, mesh_data_axis=None),
                          ptr, pte, None, **kw)
        for k in plain.final_model:
            assert torch.equal(got.final_model[k], plain.final_model[k]), k
        return
    with pytest.raises(NotImplementedError, match="ROADMAP A5.2"):
        _port_run(pm, pfl, ptr, pte, None)


def test_round_plan_refuses_a_seed_without_a_previous_aggregate():
    """The reference's seeding rules: group 0 cannot seed, a seeded group
    needs an ``agg`` on the group before it; an intermediate group may stay
    uncollapsed, the final one must collapse."""
    from repro_torch.core.plan import AggSpec, Hop, RoundPlan, VisitGroup

    hop = Hop(ids=(0, 1), plans=(np.zeros((1, 2), np.int64),) * 2)
    edges = AggSpec(groups=((0,), (1,)), lane_weights=(1.0, 1.0))
    cloud = dataclasses.replace(edges, group_weights=(0.5, 0.5))
    first = VisitGroup(hops=(hop,), agg=edges)
    seeded = VisitGroup(hops=(hop,), seed=(0, 1), agg=cloud)
    plan = RoundPlan(groups=(first, seeded))
    np.testing.assert_array_equal(plan.groups[0].agg.matrix(3),
                                  [[1, 0, 0], [0, 1, 0]])
    with pytest.raises(ValueError, match="group 0 cannot seed"):
        RoundPlan(groups=(seeded,))
    with pytest.raises(ValueError, match="missing previous aggregate"):
        RoundPlan(groups=(dataclasses.replace(first, agg=None), seeded))
    with pytest.raises(ValueError, match="final group must collapse"):
        RoundPlan(groups=(first, dataclasses.replace(seeded, agg=edges)))
