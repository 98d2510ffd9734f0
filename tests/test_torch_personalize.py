"""The port's personalization stage (``repro_torch.core.personalize``)
against the JAX package's.

* Host side, exactly: the config's fields and defaults, the label-matched
  per-client test draws, the stage's index plans block by block.
* The fleet from the same global model within 1e-4 (the narrow MLP) or
  ``CNN_RUN_ATOL`` (a narrow CNN), full and head mode, ``use_fused_sgd``
  on and off; the port's eval of the reference's fleet gives the
  reference's per-client accuracies exactly.
* Inside the port, bit for bit: head mode leaves the body as it was and
  trains every head row, blocked = the whole fleet, the device, host and
  stream stores (with and without prefetch) give the same fleet, and a
  personalize-off config is the plain run under every engine.
* ``run_experiment`` with the stage for all eight algorithms and under a
  label-flip attack against the reference's, and ``personalized.msgpack``
  saved by either package and restored by the other.
* DP-SGD with head mode moves the frozen leaves in both packages
  (ROADMAP C10).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from torch_parity import (
    CNN_RUN_ATOL, SMALL, assert_trees_close, configs, jax_init, to_numpy,
)

CPU = torch.device("cpu")
K = 8
# the stage's setting: a narrow MLP, FedAvg's shape, a dirichlet fleet
STAGE_FL = {"algorithm": "fedavg", "num_devices": K, "num_edges": 2,
            "rounds": 1, "local_epochs": 1, "batch_size": 8,
            "engine": "fused", "partition": "dirichlet", "alpha": 0.3}
NARROW_CNN = {"family": "cnn", "num_layers": 5, "image_size": 32,
              "image_channels": 3, "cnn_channels": (4, 8, 8)}


def _pers(pkg, **kw):
    import importlib

    cls = importlib.import_module(f"{pkg}.configs.base").PersonalizeConfig
    return cls(**{"epochs": 1, "lr": 0.05, "eval_per_client": 16, **kw})


def _setup(model=SMALL, task="mnist_like", pers=None, **fl_kw):
    """Both packages' (model, FLConfig with the stage, clients, test) and
    the reference's initial weights as numpy, on the same data."""
    from repro.data.pipeline import make_clients as ref_make_clients
    from repro.data.synthetic import make_task as ref_make_task
    from repro_torch.data.pipeline import make_clients
    from repro_torch.data.synthetic import make_task

    kw = {**STAGE_FL, **fl_kw}
    (rm, rfl), (pm, pfl) = configs(model, **kw)
    pers = dict(pers or {})
    rfl = dataclasses.replace(rfl, personalize=_pers("repro", **pers))
    pfl = dataclasses.replace(pfl, personalize=_pers("repro_torch", **pers))
    out = []
    for mk, mc in ((ref_make_task, ref_make_clients),
                   (make_task, make_clients)):
        train, test = mk(task, train_per_class=16, test_per_class=8, seed=0)
        clients = mc(train, scheme="dirichlet", num_devices=K,
                     rng=np.random.default_rng(0), xi=0.5, alpha=0.3)
        out.append((clients, test))
    return (rm, rfl, *out[0]), (pm, pfl, *out[1]), jax_init(rm)


def _ref_stage(rm, rfl, rc, rte, w):
    from repro.core.personalize import personalize_fleet

    return personalize_fleet(rm, rfl, rc, w, rte)


def _port_stage(pm, pfl, pc, pte, w, **kw):
    from repro_torch.core.personalize import personalize_fleet

    return personalize_fleet(pm, pfl, pc, w, pte, device="cpu", **kw)


_STAGES = {}


def _stage(**pers):
    """A cached port stage on the narrow MLP with these config fields."""
    key = tuple(sorted(pers.items()))
    if key not in _STAGES:
        fl_kw = {k: pers.pop(k) for k in ("store",) if k in pers}
        _, (pm, pfl, pc, pte), w = _setup(pers=pers, **fl_kw)
        _STAGES[key] = (_port_stage(pm, pfl, pc, pte, w), w, pm)
    return _STAGES[key]


# ---------------------------------------------------------------------------
# host side, exactly


def test_config_fields_defaults_and_validation():
    from repro_torch.configs.base import PersonalizeConfig

    pc = PersonalizeConfig()
    assert (pc.epochs, pc.lr, pc.mode, pc.batch_size, pc.block,
            pc.eval_per_client, pc.seed) == (0, 0.01, "full", 0, 0, 64, 0)
    assert not pc.active and PersonalizeConfig(epochs=1).active
    for bad in ({"epochs": -1}, {"lr": 0.0}, {"mode": "tail"},
                {"block": -1}, {"eval_per_client": 0}):
        with pytest.raises(ValueError):
            PersonalizeConfig(**bad)
    (_, (pm, pfl, pc_, pte), w) = _setup(pers={"epochs": 0})
    with pytest.raises(ValueError, match="inactive"):
        _port_stage(pm, pfl, pc_, pte, w)


@pytest.mark.parametrize("n,seed", [(16, 0), (64, 3), (5, 7)])
def test_per_client_test_sets_are_the_references(n, seed):
    from repro.core.personalize import per_client_test_sets as ref_sets
    from repro_torch.core.personalize import per_client_test_sets

    (_, _, rc, rte), (_, _, pc, pte), _ = _setup()
    ri, rl = ref_sets(rc, rte, n, 10, np.random.default_rng(seed))
    pi, pl = per_client_test_sets(pc, pte, n, 10, np.random.default_rng(seed))
    np.testing.assert_array_equal(ri, pi)
    np.testing.assert_array_equal(rl, pl)
    assert ri.dtype == pi.dtype and rl.dtype == pl.dtype


def _record_calls(monkeypatch, cls):
    """Record the (rows, plans, valid) host arrays of every
    ``train_many_fused`` call of ``cls``."""
    seen = []
    orig = cls.train_many_fused

    def rec(self, params, plane, rows, plans, valid, **kw):
        seen.append(tuple(np.asarray(a).copy() for a in (rows, plans, valid)))
        return orig(self, params, plane, rows, plans, valid, **kw)

    monkeypatch.setattr(cls, "train_many_fused", rec)
    return seen


@pytest.mark.parametrize("block,epochs", [(0, 1), (3, 2)])
def test_plans_are_the_references(monkeypatch, block, epochs):
    from repro.core.local import LocalTrainer as RefTrainer
    from repro_torch.core.local import LocalTrainer

    ref_calls = _record_calls(monkeypatch, RefTrainer)
    port_calls = _record_calls(monkeypatch, LocalTrainer)
    (rm, rfl, rc, rte), (pm, pfl, pc, pte), w = _setup(
        pers={"block": block, "epochs": epochs})
    r = _ref_stage(rm, rfl, rc, rte, w)
    p = _port_stage(pm, pfl, pc, pte, w)
    assert len(ref_calls) == len(port_calls) == r.dispatches == p.dispatches
    for a, b in zip(ref_calls, port_calls):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype


# ---------------------------------------------------------------------------
# the fleet against the reference's


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mode", ["full", "head"])
@pytest.mark.parametrize("family", ["mlp", "cnn"])
def test_fleet_matches_the_reference(family, mode, fused):
    model, task, atol = ((SMALL, "mnist_like", 1e-4) if family == "mlp"
                         else (NARROW_CNN, "cifar10_like", CNN_RUN_ATOL))
    (rm, rfl, rc, rte), (pm, pfl, pc, pte), w = _setup(
        model=model, task=task, use_fused_sgd=fused,
        pers={"mode": mode, "epochs": 2})
    r = _ref_stage(rm, rfl, rc, rte, w)
    p = _port_stage(pm, pfl, pc, pte, w)
    assert_trees_close(p.fleet, jax.device_get(r.fleet), atol=atol)
    n = pfl.personalize.eval_per_client
    np.testing.assert_array_equal(np.round(r.global_accuracy * n),
                                  np.round(p.global_accuracy * n))
    assert np.abs(r.per_client_accuracy - p.per_client_accuracy).max() \
        <= 1.0 / n + 1e-9


def test_port_eval_of_the_reference_fleet_is_exact():
    import torch as t

    from repro_torch.core.personalize import (
        lanes_accuracy, per_client_test_sets, shared_accuracy,
    )
    from repro_torch.utils.tree import ravel_params

    (rm, rfl, rc, rte), (pm, pfl, pc, pte), w = _setup(
        pers={"eval_per_client": 32, "block": 3})
    r = _ref_stage(rm, rfl, rc, rte, w)
    fleet = to_numpy(jax.device_get(r.fleet))
    names = sorted(fleet)
    arena = np.concatenate([fleet[k].reshape(K, -1) for k in names], 1)
    layout = tuple((k, fleet[k].shape[1:]) for k in names)
    flat_w = ravel_params({k: t.tensor(v) for k, v in w.items()})
    rng = np.random.default_rng((0, 2))
    for s in range(0, K, 3):        # the stage's blocks and draw order
        ids = np.arange(s, min(s + 3, K))
        imgs, labs = per_client_test_sets([pc[i] for i in ids], pte, 32, 10,
                                          rng)
        imgs, labs = t.from_numpy(imgs), t.from_numpy(labs)
        acc = lanes_accuracy(t.from_numpy(arena[ids]), imgs, labs, layout, pm)
        glob = shared_accuracy(flat_w, imgs, labs, layout, pm)
        np.testing.assert_array_equal(acc.numpy(), r.per_client_accuracy[ids])
        np.testing.assert_array_equal(glob.numpy(), r.global_accuracy[ids])


# ---------------------------------------------------------------------------
# inside the port, bit for bit


def test_head_mode_freezes_the_body_and_trains_every_head_row():
    from repro_torch.models.small import head_param_names

    report, w, pm = _stage(mode="head", epochs=2)
    head = head_param_names(pm)
    assert head == {"w2", "b2"}
    for name, leaf in report.fleet.items():
        base = np.asarray(w[name], np.float32)
        if name in head:
            moved = np.abs(leaf - base[None]).reshape(K, -1).max(axis=1)
            assert (moved > 0).all(), name
        else:
            np.testing.assert_array_equal(
                leaf, np.broadcast_to(base, leaf.shape), err_msg=name)


def test_full_mode_moves_every_leaf_of_every_client():
    report, w, _ = _stage()
    for name, leaf in report.fleet.items():
        moved = np.abs(leaf - np.asarray(w[name])[None]).reshape(K, -1)
        assert (moved.max(axis=1) > 0).all(), name


@pytest.mark.parametrize("block,n_blocks", [(0, 1), (K, 1), (3, 3), (5, 2)])
def test_one_dispatch_per_block_and_blocked_equals_whole(block, n_blocks):
    report, _, _ = _stage(block=block)
    whole, _, _ = _stage(block=K)
    assert report.dispatches == n_blocks
    assert report.per_client_accuracy.shape == (K,)
    assert report.seconds > 0
    np.testing.assert_array_equal(report.arena, whole.arena)
    np.testing.assert_array_equal(report.per_client_accuracy,
                                  whole.per_client_accuracy)


@pytest.mark.parametrize("store", ["host", "stream"])
def test_staged_store_default_block_and_fleet(store):
    report, _, _ = _stage(store=store)
    device, _, _ = _stage()
    assert report.dispatches == 1      # min(K, 64) = K clients a block
    np.testing.assert_array_equal(report.arena, device.arena)


def _run(fl, model=SMALL, init=None, **kw):
    from repro_torch.core.executor import run_experiment
    from repro_torch.data.synthetic import make_task

    train, test = make_task("mnist_like", train_per_class=16,
                            test_per_class=8, seed=0)
    return run_experiment(task="mnist_like", model_cfg=model, fl=fl,
                          train=train, test=test, init_params=init,
                          device="cpu", **kw)


_RUN_CACHE = {}


def _port_run(store="device", prefetch=0, engine="fused", **pers):
    key = (store, prefetch, engine, tuple(sorted(pers.items())))
    if key not in _RUN_CACHE:
        (rm, _), (pm, pfl) = configs(SMALL, **{**STAGE_FL, "rounds": 2,
                                               "store": store,
                                               "prefetch": prefetch,
                                               "engine": engine})
        pfl = dataclasses.replace(
            pfl, personalize=_pers("repro_torch", **{"block": 3, **pers}))
        _RUN_CACHE[key] = _run(pfl, pm, jax_init(rm))
    return _RUN_CACHE[key]


@pytest.mark.parametrize("store,prefetch", [("host", 0), ("host", 1),
                                            ("stream", 0), ("stream", 1),
                                            ("device", 1)])
def test_stores_and_prefetch_give_the_same_fleet(store, prefetch):
    base = _port_run()
    res = _port_run(store, prefetch)
    for k in base.personalized_fleet:
        np.testing.assert_array_equal(res.personalized_fleet[k],
                                      base.personalized_fleet[k], err_msg=k)
    assert res.personalized_accuracy == base.personalized_accuracy
    assert res.global_client_accuracy == base.global_client_accuracy
    assert res.stage_seconds > 0


@pytest.mark.parametrize("engine", ["fused", "batched", "sequential"])
def test_personalize_off_is_the_plain_run(engine):
    from repro_torch.configs.base import PersonalizeConfig

    (rm, _), (pm, pfl) = configs(SMALL, **{**STAGE_FL, "engine": engine})
    init = jax_init(rm)
    plain = _run(pfl, pm, init)
    off = _run(dataclasses.replace(pfl, personalize=PersonalizeConfig(
        epochs=0, lr=0.5, mode="head", block=3, seed=9)), pm, init)
    assert off.personalized_accuracy is None
    assert off.global_client_accuracy is None
    assert off.personalized_fleet is None
    for k in plain.final_model:
        assert torch.equal(plain.final_model[k], off.final_model[k]), k
    assert [(r.round, r.accuracy, r.comm) for r in plain.history] == \
        [(r.round, r.accuracy, r.comm) for r in off.history]
    assert (plain.h2d_bytes, plain.dispatches) == (off.h2d_bytes,
                                                   off.dispatches)


def test_the_stage_runs_under_every_engine_with_the_same_fleet():
    fused = _port_run()
    for engine in ("batched", "sequential"):
        res = _port_run(engine=engine)
        # the engines' round-1 models agree within 1e-6 (sequential rounds
        # its update otherwise, ROADMAP C2); the stage starts from them
        assert_trees_close(res.personalized_fleet, fused.personalized_fleet,
                           atol=1e-5)


# ---------------------------------------------------------------------------
# run_experiment against the reference


_ALGO_KW = {"fedsr": {"ring_rounds": 2}, "fedavg": {}, "ring": {},
            "fedprox": {"mu": 0.1}, "hieravg": {"ring_rounds": 2},
            "moon": {"mu": 1.0}, "scaffold": {"momentum": 0.0},
            "centralized": {}}


def _both_runs(monkeypatch, algorithm, pers, **fl_kw):
    from repro.core.executor import run_experiment as ref_run
    from repro.data.synthetic import make_task as ref_make_task
    from repro_torch.data.synthetic import make_task

    kw = {**STAGE_FL, "algorithm": algorithm, "num_devices": 4,
          "rounds": 1, **_ALGO_KW[algorithm], **fl_kw}
    (rm, rfl), (pm, pfl) = configs(SMALL, **kw)
    rfl = dataclasses.replace(rfl, personalize=_pers("repro", **pers))
    pfl = dataclasses.replace(pfl, personalize=_pers("repro_torch", **pers))
    rtr, rte = ref_make_task("mnist_like", train_per_class=8,
                             test_per_class=4, seed=0)
    ref = ref_run(task="mnist_like", model_cfg=rm, fl=rfl, train=rtr,
                  test=rte)
    from repro_torch.core.executor import run_experiment

    ptr, pte = make_task("mnist_like", train_per_class=8, test_per_class=4,
                         seed=0)
    port = run_experiment(task="mnist_like", model_cfg=pm, fl=pfl, train=ptr,
                          test=pte, init_params=jax_init(rm), device="cpu")
    return ref, port, pfl


def _assert_stage_close(ref, port, n):
    assert_trees_close(port.personalized_fleet,
                       jax.device_get(ref.personalized_fleet), atol=1e-4)
    assert abs(ref.personalized_accuracy - port.personalized_accuracy) \
        <= 1.0 / n + 1e-9
    assert abs(ref.global_client_accuracy - port.global_client_accuracy) \
        <= 1.0 / n + 1e-9
    assert_trees_close(port.final_model, ref.final_model, atol=1e-4)


@pytest.mark.parametrize("algorithm", sorted(_ALGO_KW))
def test_run_experiment_with_the_stage_matches_the_reference(monkeypatch,
                                                             algorithm):
    ref, port, pfl = _both_runs(
        monkeypatch, algorithm, {"mode": "head" if algorithm in (
            "moon", "ring", "hieravg") else "full", "block": 3},
        use_fused_sgd=algorithm in ("fedsr", "moon", "fedprox"))
    _assert_stage_close(ref, port, pfl.personalize.eval_per_client)


def test_label_flip_run_fine_tunes_on_the_poisoned_shards(monkeypatch):
    ref, port, pfl = _both_runs(
        monkeypatch, "fedavg", {},
        adversary={"frac": 0.5, "kind": "label_flip", "seed": 1})
    _assert_stage_close(ref, port, pfl.personalize.eval_per_client)
    clean, _, _ = _both_runs(monkeypatch, "fedavg", {})
    assert max(np.abs(clean.personalized_fleet[k]
                      - ref.personalized_fleet[k]).max()
               for k in clean.personalized_fleet) > 1e-3


# ---------------------------------------------------------------------------
# personalized.msgpack across the packages


@pytest.mark.parametrize("saver", ["repro", "repro_torch"])
def test_personalized_msgpack_restores_across_packages(tmp_path, saver):
    from repro.core.personalize import (
        restore_personalized as ref_restore, save_personalized as ref_save,
    )
    from repro_torch.core.personalize import (
        fleet_views, restore_personalized, save_personalized,
    )

    report, w, _ = _stage(block=3)
    layout = report.layout
    ck = str(tmp_path)
    if saver == "repro":
        ref_save(ck, {k: np.array(v) for k, v in report.fleet.items()}, K)
        back = restore_personalized(ck, layout, K)
        np.testing.assert_array_equal(back, report.arena)
    else:
        save_personalized(ck, report.arena, layout)
        back = ref_restore(ck, {k: np.asarray(v) for k, v in w.items()}, K)
        for k, v in fleet_views(report.arena, layout).items():
            np.testing.assert_array_equal(np.asarray(back[k]), v, err_msg=k)
    assert restore_personalized(str(tmp_path / "none"), layout, K) is None


def test_run_experiment_saves_personalized_msgpack(tmp_path):
    from repro_torch.core.personalize import restore_personalized

    (rm, _), (pm, pfl) = configs(SMALL, **STAGE_FL)
    pfl = dataclasses.replace(pfl, personalize=_pers("repro_torch"))
    res = _run(pfl, pm, jax_init(rm), checkpoint_dir=str(tmp_path))
    layout = tuple((k, v.shape[1:]) for k, v in
                   sorted(res.personalized_fleet.items()))
    back = restore_personalized(str(tmp_path), layout, K)
    for k, v in zip(sorted(res.personalized_fleet),
                    np.split(back, np.cumsum(
                        [int(np.prod(s)) for _, s in layout])[:-1], axis=1)):
        np.testing.assert_array_equal(
            v.reshape(res.personalized_fleet[k].shape),
            res.personalized_fleet[k], err_msg=k)


# ---------------------------------------------------------------------------
# the trainer's gradient mask and DP-SGD (ROADMAP C10)


def test_grad_mask_freezes_leaves_on_every_trainer_path():
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.local import LocalTrainer
    from repro_torch.data.pipeline import stack_plans
    from repro_torch.models.small import head_grad_mask, params_from_numpy
    from repro_torch.utils.tree import ravel_params, unravel

    (_, _, _, _), (pm, _, pc, _), w = _setup()
    params = params_from_numpy(w, CPU)
    flat = ravel_params(params)
    for fused in (True, False):
        tr = LocalTrainer(pm, FLConfig(batch_size=8, use_fused_sgd=fused),
                          CPU, grad_mask=head_grad_mask(params, pm))
        one = unravel(tr.train(flat, pc[0], lr=0.1, epochs=1,
                               rng=np.random.default_rng(0)), tr.layout)
        plans = [np.arange(8).reshape(1, 8) for _ in pc[:3]]
        batches, valid = stack_plans(pc[:3], plans)
        many = unravel(tr.train_many(flat, batches, valid, lr=0.1,
                                     broadcast=True), tr.layout)
        for k in params:
            frozen = k not in ("w2", "b2")
            assert torch.equal(one[k], params[k]) == frozen, k
            assert all(torch.equal(many[k][c], params[k]) == frozen
                       for c in range(3)), k


def test_train_many_fused_seeds_every_lane_and_keeps_the_model():
    """Every lane starts from the (P,) model, which the steps leave as it
    was; a lane with no valid step returns the model unchanged; the call
    is one dispatch and meters its three host arrays."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.local import LocalTrainer
    from repro_torch.data.pipeline import DeviceDataPlane, stack_plan_indices
    from repro_torch.models.small import params_from_numpy
    from repro_torch.utils.tree import ravel_params

    (_, _, _, _), (pm, _, pc, _), w = _setup()
    flat = ravel_params(params_from_numpy(w, CPU))
    seed = flat.clone()
    tr = LocalTrainer(pm, FLConfig(batch_size=8), CPU)
    plans = [np.arange(8).reshape(1, 8), None, np.arange(8).reshape(1, 8)]
    rows, idx, valid = stack_plan_indices(plans, [0, 1, 0])
    out = tr.train_many_fused(flat, DeviceDataPlane(pc, CPU), rows[None],
                              idx[None], valid[None], lr=0.1)
    assert torch.equal(flat, seed)
    assert out.shape == (3, flat.numel())
    assert torch.equal(out[1], seed) and torch.equal(out[0], out[2])
    assert not torch.equal(out[0], seed)
    assert tr.dispatches == 1
    assert tr.h2d_bytes == rows.nbytes + idx.nbytes + valid.nbytes


def test_dp_noise_moves_the_frozen_body_in_both_packages():
    (rm, rfl, rc, rte), (pm, pfl, pc, pte), w = _setup(
        dp_clip=1.0, dp_noise_mult=1.0, pers={"mode": "head"})
    r = _ref_stage(rm, rfl, rc, rte, w)
    p = _port_stage(pm, pfl, pc, pte, w)
    for fleet in (jax.device_get(r.fleet), p.fleet):
        for name in ("w0", "b0", "w1", "b1"):
            moved = np.abs(np.asarray(fleet[name]) - w[name][None])
            assert (moved.reshape(K, -1).max(axis=1) > 1e-3).all(), name
