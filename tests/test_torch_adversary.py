"""The port's adversary (``core/adversary.py``, ``VisitGroup.lane_scale``
in every engine, the label-flip poison of ``core/executor.py``) against
the JAX package's.

* Units, case for case with the adversary cases of
  ``tests/test_adversary.py``: the attacker draw is deterministic, of the
  right size and the reference's; ``poison_clients`` flips only attacker
  shards, byte-equal to the reference's labels; an inactive or
  data-poisoning adversary leaves plans as they are; ``lane_scale`` is the
  reference's for the same plans, including a ring lane with one attacker
  and an attacker that dropped out of the round; Centralized rejects both
  axes.
* Whole runs against the reference: FedAvg, FedSR and HierFAVG under
  ``sign_flip`` and ``scale`` with the ``weighted_mean`` reduce, under the
  three engines: plans (their ``lane_scale`` too), the RNG state after
  each block, comm, ``h2d_bytes`` and ``dispatches`` exact, final models
  within 1e-4; inside the port batched bit-equal to fused, sequential
  within 1e-6, and a chunked attacked block bit-equal to the per-round
  driver in one call. ``label_flip`` leaves plans and comm as the honest
  run has them and moves the model (as the reference's does), under every
  store. Sign-flip composed with ``drop_rate=0.3`` on FedAvg and FedSR, as
  ``test_attacked_drop_round_parity`` composes them.

The reference's runs share one ``LocalTrainer``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (
    SMALL, assert_histories_equal, assert_schedules_equal,
    assert_trees_close, configs, jax_init, mnist_tasks, record_plans,
)

CPU = torch.device("cpu")
ENGINES = ("fused", "batched", "sequential")
SIGNFLIP = {"frac": 0.25, "kind": "sign_flip"}
SCALE = {"frac": 0.25, "kind": "scale"}          # the default scale, 10
LABELFLIP = {"frac": 0.5, "kind": "label_flip"}
# the whole-run setting (engine_parity's: K=8, M=2, R=2, E=1, batch 8,
# momentum 0.5, dirichlet alpha 0.5), two rounds in one block
RUN_FL = dict(num_devices=8, num_edges=2, ring_rounds=2, local_epochs=1,
              batch_size=8, momentum=0.5, partition="dirichlet", alpha=0.5,
              seed=3, rounds=2)

_RUNS = {}


def _task():
    if "task" not in _RUNS:
        _RUNS["task"] = mnist_tasks(train_per_class=10, test_per_class=2)
    return _RUNS["task"]


# ---------------------------------------------------------------------------
# AdversaryState units


@pytest.mark.parametrize("frac,k,seed", [(0.25, 20, 5), (0.2, 100, 0),
                                         (0.5, 8, 3), (0.05, 8, 1)])
def test_attacker_draw_is_the_reference(frac, k, seed):
    from repro.configs.base import AdversaryConfig as RefAdversary
    from repro.core.adversary import AdversaryState as RefState
    from repro_torch.configs.base import AdversaryConfig
    from repro_torch.core.adversary import AdversaryState

    cfg = dict(frac=frac, kind="sign_flip", seed=seed)
    a = AdversaryState(AdversaryConfig(**cfg), k)
    assert a.attackers.sum() == round(k * frac)
    np.testing.assert_array_equal(
        a.attackers, AdversaryState(AdversaryConfig(**cfg), k).attackers)
    ref = RefState(RefAdversary(**cfg), k)
    assert a.attackers.tobytes() == ref.attackers.tobytes()
    assert (a.active, a.byzantine) == (ref.active, ref.byzantine)
    assert not AdversaryState(AdversaryConfig(), k).active


@pytest.mark.parametrize("bad", [{"frac": 1.5}, {"frac": -0.1},
                                 {"kind": "gauss"}, {"scale": 0.0}])
def test_adversary_config_rejects_bad_knobs(bad):
    from repro.configs.base import AdversaryConfig as RefAdversary
    from repro_torch.configs.base import AdversaryConfig

    with pytest.raises(ValueError):
        RefAdversary(**bad)
    with pytest.raises(ValueError):
        AdversaryConfig(**bad)


def _clients(pkg):
    import importlib

    make_clients = importlib.import_module(f"{pkg}.data.pipeline").make_clients
    tasks = _task()
    train = tasks[0][0] if pkg == "repro" else tasks[1][0]
    return make_clients(train, scheme="dirichlet", num_devices=8,
                        rng=np.random.default_rng(0), alpha=0.5)


def test_poison_flips_only_attacker_shards_as_the_reference():
    from repro.configs.base import AdversaryConfig as RefAdversary
    from repro.core.adversary import AdversaryState as RefState
    from repro.data.partition import poison_labels as ref_poison
    from repro_torch.configs.base import AdversaryConfig
    from repro_torch.core.adversary import AdversaryState
    from repro_torch.data.partition import poison_labels

    clients = _clients("repro_torch")
    adv = AdversaryState(AdversaryConfig(**LABELFLIP), 8)
    out = adv.poison_clients(clients, 10)
    ref = RefState(RefAdversary(**LABELFLIP), 8).poison_clients(
        _clients("repro"), 10)
    assert adv.attackers.sum() == 4
    for i, (c, p, r) in enumerate(zip(clients, out, ref)):
        np.testing.assert_array_equal(p.images, c.images)
        if adv.attackers[i]:
            np.testing.assert_array_equal(p.labels, 9 - c.labels)
        else:
            assert p is c
        assert p.labels.dtype == r.labels.dtype
        assert p.labels.tobytes() == r.labels.tobytes()
    labels = np.arange(10, dtype=np.int32)
    assert poison_labels(labels, 10).tobytes() == ref_poison(labels,
                                                             10).tobytes()
    with pytest.raises(ValueError, match="2 classes"):
        poison_labels(labels, 1)
    # the Byzantine kinds and an empty draw leave the shards alone
    for cfg in (SIGNFLIP, {"frac": 0.0, "kind": "label_flip"}):
        assert AdversaryState(AdversaryConfig(**cfg), 8).poison_clients(
            clients, 10) is clients


def _planners(algo, adversary, **overrides):
    """The ``algo`` planner of each package over identical clients."""
    from repro.core.algorithms import make_algorithm as ref_make_algorithm
    from repro.core.local import LocalTrainer as RefTrainer
    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.core.local import LocalTrainer

    kw = dict(algorithm=algo, num_devices=8, num_edges=2, rounds=2,
              ring_rounds=2, local_epochs=1, batch_size=8, momentum=0.5,
              engine="fused", adversary=adversary)
    kw.update(overrides)
    (rm, rfl), (pm, pfl) = configs(SMALL, **kw)
    return (ref_make_algorithm(algo, RefTrainer(rm, rfl), _clients("repro"),
                               rfl),
            make_algorithm(algo, LocalTrainer(pm, pfl, CPU),
                           _clients("repro_torch"), pfl))


def test_inactive_or_poisoning_adversary_leaves_plans_alone():
    """``transform`` is the identity without a Byzantine adversary; with
    one it draws nothing and changes nothing but ``lane_scale``."""
    _, honest = _planners("fedsr", {})
    r0 = np.random.default_rng(7)
    base = honest.plan_round(0, r0, {})
    for adv in ({}, LABELFLIP, {"frac": 0.0, "kind": "scale"}):
        _, port = _planners("fedsr", adv)
        assert not port.adversary.byzantine
        assert port.adversary.transform(base) is base
    _, port = _planners("fedsr", SIGNFLIP)
    rng = np.random.default_rng(7)
    plan = port.plan_round(0, rng, {})
    assert rng.bit_generator.state == r0.bit_generator.state
    assert plan.comm == base.comm and plan.sim_seconds == base.sim_seconds
    (g,), (g0,) = plan.groups, base.groups
    assert g.agg == g0.agg and g0.lane_scale is None
    assert g.lane_scale is not None and -1.0 in g.lane_scale
    for h, h0 in zip(g.hops, g0.hops):
        assert h.ids == h0.ids
        for a, b in zip(h.plans, h0.plans):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("algo,adv,scenario", [
    ("fedavg", SIGNFLIP, {}), ("fedsr", SCALE, {}),
    ("hieravg", SIGNFLIP, {}), ("ring", SCALE, {}),
    ("fedsr", SIGNFLIP, {"drop_rate": 0.5, "seed": 4}),
    ("fedavg", {"frac": 0.5, "kind": "scale", "scale": 3.0},
     {"drop_rate": 0.5, "seed": 4})])
def test_lane_scale_is_the_reference(algo, adv, scenario):
    """The same plans in both packages carry the same ``lane_scale``: a
    ring lane is attacked when any member with a real visit attacks, an
    attacker that dropped out uploads nothing (its lane stays honest, or
    weighs 0), and every HierFAVG iteration carries the same factors."""
    ref, port = _planners(algo, adv, scenario=scenario, participation=0.75)
    rr, pr = np.random.default_rng(3), np.random.default_rng(3)
    rs = ref.plan_schedule(0, 3, rr, {})
    ps = port.plan_schedule(0, 3, pr, {})
    assert_schedules_equal(rs, ps)
    assert rr.bit_generator.state == pr.bit_generator.state
    t = -1.0 if adv["kind"] == "sign_flip" else float(adv.get("scale", 10.0))
    attacked = 0
    for plan in ps.plans:
        for g in plan.groups:
            want = tuple(
                t if any(port.adversary.attackers[h.ids[c]]
                         and h.plans[c] is not None for h in g.hops) else 1.0
                for c in range(g.lanes))
            assert (g.lane_scale or (1.0,) * g.lanes) == want
            attacked += sum(s != 1.0 for s in want)
        if algo == "hieravg":
            assert len({g.lane_scale for g in plan.groups}) == 1
    assert attacked > 0
    if algo == "fedsr" and not scenario:
        # a ring of four with one attacker: the whole lane is attacked
        g = ps.plans[0].groups[0]
        for c, s in enumerate(g.lane_scale):
            members = {h.ids[c] for h in g.hops if h.plans[c] is not None}
            n_att = sum(port.adversary.attackers[i] for i in members)
            assert (s != 1.0) == (n_att > 0)
    lrs = np.asarray([0.05, 0.04, 0.03])
    if algo == "hieravg":
        rxs = ref.engine._stack_hier_schedule(rs.plans, lrs)
        pxs = port.engine._stack_hier_schedule(ps.plans, lrs)
    else:
        rxs = ref.engine._stack_cohort_schedule(rs.plans, lrs, "plain", {})
        pxs = port.engine._stack_cohort_schedule(ps.plans, lrs)
    assert "dscale" in pxs and sorted(rxs) == sorted(pxs)
    for k in pxs:
        assert rxs[k].dtype == pxs[k].dtype, k
        assert rxs[k].tobytes() == pxs[k].tobytes(), k


@pytest.mark.parametrize("axis", ["scenario", "adversary"])
def test_centralized_rejects_both_axes(axis):
    from repro_torch.core.executor import run_experiment

    value = {"drop_rate": 0.25} if axis == "scenario" else LABELFLIP
    _, (pm, pfl) = configs(SMALL, algorithm="centralized", **{axis: value},
                           **RUN_FL)
    _, (ptr, pte) = _task()
    with pytest.raises(ValueError, match="bypasses the RoundPlan IR"):
        run_experiment(task="mnist_like", model_cfg=pm, fl=pfl, train=ptr,
                       test=pte, device="cpu")


# ---------------------------------------------------------------------------
# whole runs


def _init():
    if "init" not in _RUNS:
        rm, _ = configs(SMALL)[0]
        _RUNS["init"] = jax_init(rm, RUN_FL["seed"])
    return _RUNS["init"]


def _ref_run(monkeypatch, algo, engine, adversary, scenario):
    """The reference's ``run_experiment`` on the shared trainer: its
    result, planned blocks and the trainer's meters."""
    import repro.core.executor as ref_executor
    from repro.core.local import LocalTrainer

    (rm, rfl), _ = configs(SMALL, algorithm=algo, engine=engine,
                           adversary=adversary, scenario=scenario, **RUN_FL)
    (rtr, rte), _ = _task()
    if "ref_trainer" not in _RUNS:
        _RUNS["ref_trainer"] = LocalTrainer(rm, rfl)
    tr = _RUNS["ref_trainer"]
    tr.h2d_bytes = tr.dispatches = 0
    with monkeypatch.context() as m:
        m.setattr(ref_executor, "LocalTrainer", lambda *a, **k: tr)
        plans = record_plans(m, "repro.core.algorithms")
        res = ref_executor.run_experiment(
            task="mnist_like", model_cfg=rm, fl=rfl, train=rtr, test=rte,
            eval_every=2)
    return res, plans, (tr.h2d_bytes, tr.dispatches)


def _port_run(algo, engine, adversary, scenario=None, eval_every=2,
              **fl_kw):
    """A cached port run at ``RUN_FL`` from the reference's initial
    weights: ``(result, recorded blocks)``."""
    from repro_torch.core.executor import run_experiment

    key = (algo, engine, repr(adversary), repr(scenario), eval_every,
           repr(sorted(fl_kw.items())))
    if key not in _RUNS:
        _, (pm, pfl) = configs(SMALL, algorithm=algo, engine=engine,
                               adversary=adversary, scenario=scenario or {},
                               **dict(RUN_FL, **fl_kw))
        _, (ptr, pte) = _task()
        with pytest.MonkeyPatch.context() as m:
            plans = record_plans(m, "repro_torch.core.algorithms")
            res = run_experiment(task="mnist_like", model_cfg=pm, fl=pfl,
                                 train=ptr, test=pte, init_params=_init(),
                                 device="cpu", eval_every=eval_every)
        _RUNS[key] = (res, plans)
    return _RUNS[key]


def _assert_matches_reference(monkeypatch, algo, engine, adversary,
                              scenario=None):
    ref, ref_plans, (h2d, dispatches) = _ref_run(
        monkeypatch, algo, engine, adversary, scenario or {})
    port, plans = _port_run(algo, engine, adversary, scenario)
    assert len(plans) == len(ref_plans) == 1
    for (ta, sa, ra), (tb, sb, rb) in zip(ref_plans, plans):
        assert ta == tb and ra == rb
        assert_schedules_equal(sa, sb)
    assert any(g.lane_scale is not None for _, s, _ in plans
               for p in s.plans for g in p.groups)
    _, (_, pte) = _task()
    assert_histories_equal(ref, port, len(pte))
    assert port.h2d_bytes == h2d and port.dispatches == dispatches
    assert_trees_close(port.final_model, ref.final_model, atol=1e-4)
    for v in port.final_model.values():
        assert torch.isfinite(v).all()


ATTACKS = {"sign_flip": SIGNFLIP, "scale": SCALE}
REF_CASES = [(a, k, e) for a in ("fedavg", "fedsr", "hieravg")
             for k in ATTACKS for e in ENGINES]


@pytest.mark.parametrize("algo,kind,engine", REF_CASES,
                         ids=["-".join(c) for c in REF_CASES])
def test_attacked_run_matches_reference(monkeypatch, algo, kind, engine):
    _assert_matches_reference(monkeypatch, algo, engine, ATTACKS[kind])


def _bit_equal(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def _max_diff(a, b) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


@pytest.mark.parametrize("kind", list(ATTACKS))
@pytest.mark.parametrize("algo", ["fedavg", "fedsr", "hieravg", "ring",
                                  "fedprox", "moon", "scaffold"])
def test_engines_agree_under_attack(algo, kind):
    """Batched bit-equal to fused and sequential within 1e-6 (ROADMAP C2;
    the scale attack multiplies the delta's rounding by its factor, so
    the sequential bound is the factor times 1e-6), the attack moves the
    model, and the fused engine's chunked block equals its per-round
    driver bit for bit in one call."""
    adv = ATTACKS[kind]
    runs = {e: _port_run(algo, e, adv)[0] for e in ENGINES}
    fused = runs["fused"]
    assert _bit_equal(runs["batched"].final_model, fused.final_model)
    scale = 10.0 if kind == "scale" else 1.0
    assert _max_diff(runs["sequential"].final_model,
                     fused.final_model) <= scale * 1e-6
    honest = _port_run(algo, "fused", {})[0]
    assert _max_diff(honest.final_model, fused.final_model) > 1e-3
    per_round = _port_run(algo, "fused", adv, eval_every=1)[0]
    assert _bit_equal(per_round.final_model, fused.final_model)
    assert (fused.dispatches, per_round.dispatches) == (1, 2)


@pytest.mark.parametrize("engine", ["fused", "batched"])
@pytest.mark.parametrize("algo", ["fedavg", "fedsr"])
def test_attacked_drop_run_matches_reference(monkeypatch, algo, engine):
    """Sign-flip composed with ``drop_rate=0.3``: an attacker that dropped
    uploads nothing, its lane weighs 0; against the reference, and
    batched bit-equal to fused."""
    drop = {"drop_rate": 0.3}
    _assert_matches_reference(monkeypatch, algo, engine, SIGNFLIP, drop)
    a = _port_run(algo, "fused", SIGNFLIP, drop)[0]
    b = _port_run(algo, "batched", SIGNFLIP, drop)[0]
    assert _bit_equal(a.final_model, b.final_model)


def test_label_flip_changes_training_not_plans(monkeypatch):
    """``label_flip`` poisons the data before the engine stages it: the
    plans, RNG stream and comm equal the honest run's, only the model
    moves; against the reference within 1e-4, and every store serves the
    poisoned shards (``store="host"`` and ``"stream"`` bit-equal to the
    resident store)."""
    from repro.core.executor import run_experiment as ref_run

    honest, hp = _port_run("fedavg", "fused", {})
    flip, fp = _port_run("fedavg", "fused", LABELFLIP)
    assert honest.history[-1].comm == flip.history[-1].comm
    for (ta, sa, ra), (tb, sb, rb) in zip(hp, fp):
        assert ra == rb
        assert_schedules_equal(sa, sb)
    assert _max_diff(honest.final_model, flip.final_model) > 0.0
    (rm, rfl), _ = configs(SMALL, algorithm="fedavg", engine="batched",
                           adversary=LABELFLIP, **RUN_FL)
    (rtr, rte), _ = _task()
    ref = ref_run(task="mnist_like", model_cfg=rm, fl=rfl, train=rtr,
                  test=rte, eval_every=2)
    assert ref.history[-1].comm == flip.history[-1].comm
    assert_trees_close(flip.final_model, ref.final_model, atol=1e-4)
    for store in ("host", "stream"):
        staged, _ = _port_run("fedavg", "fused", LABELFLIP, store=store,
                              prefetch=1)
        assert _bit_equal(staged.final_model, flip.final_model), store
    seq, _ = _port_run("fedavg", "sequential", LABELFLIP)
    assert _max_diff(seq.final_model, flip.final_model) <= 1e-6
