"""The port's scenario axis (``core/scenario.py`` and the planner seam of
``core/algorithms.py``) against the JAX package's.

* Units, case for case with ``tests/test_scenario.py``: config
  validation; the drop fraction, always with a survivor; train-slow
  truncates steps only; staleness decays and renormalizes; ``_rescale_agg``
  zeroes dead groups; an inactive scenario is the identity and draws
  nothing; the clock's closed form (the slowest rate, the time threshold);
  the meter accumulates ``sim_seconds``. Across the packages: for the same
  plan and RNG state, ``transform`` gives equal plans, dropped sets and RNG
  states; ``ScenarioState``'s draws are equal; the transformed plans of
  every planner, their comm and the fused block arrays are equal byte for
  byte.
* Whole runs under the reference's ``FULL`` scenario (every knob at once)
  against the reference: the seven algorithms of ``engine_parity.ALGOS``
  on the fused engine, and a cut of them on the batched and sequential
  engines. Plans, the RNG state after each block, comm (with
  ``sim_seconds``), ``h2d_bytes``, ``dispatches`` and
  ``peak_device_bytes`` exact; final models within 1e-4 (ROADMAP C8).
* Inside the port, under ``FULL``: batched bit-equal to fused and
  sequential within 1e-6 for every algorithm; a chunked block bit-equal to
  the per-round driver and one call; MOON's and SCAFFOLD's dead lanes left
  out of their state; MOON and SCAFFOLD under ``store="host"``,
  ``prefetch=1`` bit-equal to ``store="device"``, ``prefetch=0``; a FedSR
  run stopped and resumed bit-equal to the uninterrupted one; and
  ``ScenarioConfig()`` bit-equal to the planner without the scenario seam,
  with the same RNG state.

The reference's runs share one ``LocalTrainer``, so its compiled steps
stay warm across the cases.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (
    SMALL, assert_histories_equal, assert_schedules_equal,
    assert_trees_close, configs, jax_init, mnist_tasks, record_plans,
)

CPU = torch.device("cpu")
ALGOS = ["fedavg", "fedprox", "moon", "scaffold", "fedsr", "ring", "hieravg"]
ENGINES = ("fused", "batched", "sequential")

# every knob at once (the reference's tests/test_scenario.py FULL): drops,
# truncated steps, staleness decay, a 4x rate spread and a transfer cost
FULL = dict(drop_rate=0.25, train_slow_frac=0.25, send_slow_frac=0.25,
            slow_step_factor=0.5, staleness_horizon=3, staleness_decay=0.5,
            rate_min=0.5, rate_max=2.0, transfer_seconds=0.01, seed=3)
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
# config validation


@pytest.mark.parametrize("bad", [
    {"drop_rate": 1.0}, {"drop_rate": -0.1}, {"train_slow_frac": 1.5},
    {"send_slow_frac": -0.5}, {"slow_step_factor": 0.0},
    {"staleness_horizon": -1}, {"rate_min": 0.0},
    {"rate_min": 2.0, "rate_max": 1.0}, {"transfer_seconds": -1.0},
])
def test_scenario_config_rejects_bad_knobs(bad):
    from repro.configs.base import ScenarioConfig as RefScenario
    from repro_torch.configs.base import ScenarioConfig

    with pytest.raises(ValueError):
        RefScenario(**bad)
    with pytest.raises(ValueError):
        ScenarioConfig(**bad)


def test_default_scenario_is_inactive():
    from repro_torch.configs.base import ScenarioConfig

    assert not ScenarioConfig().active
    assert ScenarioConfig(**FULL).active
    # the clock-only knobs shape the simulated clock, not the plans
    assert not ScenarioConfig(rate_min=0.5, rate_max=2.0,
                              transfer_seconds=1.0).active


# ---------------------------------------------------------------------------
# units: the draws and the transform on real planners' plans


def _planners(algo="fedavg", scenario=FULL, **overrides):
    """The ``algo`` planner of each package (the reference's
    ``test_scenario._planner`` setting) over identical clients."""
    from repro.core.algorithms import make_algorithm as ref_make_algorithm
    from repro.core.local import LocalTrainer as RefTrainer
    from repro.data.pipeline import make_clients as ref_make_clients
    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.core.local import LocalTrainer
    from repro_torch.data.pipeline import make_clients

    kw = dict(algorithm=algo, num_devices=8, num_edges=2, rounds=2,
              ring_rounds=2, local_epochs=1, batch_size=8, momentum=0.5,
              engine="fused", scenario=scenario)
    kw.update(overrides)
    (rm, rfl), (pm, pfl) = configs(SMALL, **kw)
    (rtr, _), (ptr, _) = _task()
    rc = ref_make_clients(rtr, scheme="dirichlet", num_devices=8,
                          rng=np.random.default_rng(0), alpha=0.5)
    pc = make_clients(ptr, scheme="dirichlet", num_devices=8,
                      rng=np.random.default_rng(0), alpha=0.5)
    return (ref_make_algorithm(algo, RefTrainer(rm, rfl), rc, rfl),
            make_algorithm(algo, LocalTrainer(pm, pfl, CPU), pc, pfl))


def _port_planner(algo="fedavg", scenario=FULL, **overrides):
    return _planners(algo, scenario, **overrides)[1]


def test_drop_rate_drops_that_fraction_with_survivors():
    from repro_torch.core.scenario import plan_participants

    algo = _port_planner(scenario={"drop_rate": 0.25})
    plan = algo.plan_round(0, np.random.default_rng(7), {})
    # 8 participants * 0.25 -> exactly 2 dropped: their visits are None
    assert len(plan_participants(plan)) == 6
    grp = plan.groups[0]
    dead = [c for c in range(grp.lanes) if grp.hops[0].plans[c] is None]
    assert len(dead) == 2
    lw = np.asarray(grp.agg.lane_weights)
    assert all(lw[c] == 0.0 for c in dead)
    assert np.isclose(lw.sum(), 1.0)


def test_drop_always_leaves_a_survivor():
    from repro_torch.core.scenario import plan_participants

    # drop_rate .9 on 8 participants rounds to 7 dropped, never 8
    algo = _port_planner(scenario={"drop_rate": 0.9})
    for t in range(4):
        plan = algo.plan_round(t, np.random.default_rng(t), {})
        assert len(plan_participants(plan)) == 1


def test_train_slow_truncates_steps_only():
    from repro_torch.configs.base import ScenarioConfig
    from repro_torch.core.scenario import ScenarioState

    sc = dict(train_slow_frac=0.5, slow_step_factor=0.5, seed=3)
    slow = ScenarioState(ScenarioConfig(**sc), 8).train_slow
    assert slow.sum() == 4
    base = _port_planner(scenario={}).plan_round(
        0, np.random.default_rng(7), {})
    plan = _port_planner(scenario=sc).plan_round(
        0, np.random.default_rng(7), {})
    hop0, hop1 = base.groups[0].hops[0], plan.groups[0].hops[0]
    assert hop0.ids == hop1.ids
    for i, p0, p1 in zip(hop0.ids, hop0.plans, hop1.plans):
        if slow[i]:
            assert p1.shape[0] == max(1, int(np.ceil(p0.shape[0] * 0.5)))
            np.testing.assert_array_equal(p1, p0[: p1.shape[0]])
        else:
            np.testing.assert_array_equal(p1, p0)
    # slow clients are late, not stale: their weights are untouched
    assert plan.groups[0].agg.lane_weights == base.groups[0].agg.lane_weights


def test_staleness_decays_and_renormalizes_weights():
    from repro_torch.configs.base import ScenarioConfig
    from repro_torch.core.scenario import ScenarioState

    sc = dict(send_slow_frac=0.5, staleness_horizon=3, staleness_decay=0.5,
              seed=3)
    st = ScenarioState(ScenarioConfig(**sc), 8)
    base = _port_planner(scenario={}).plan_round(
        0, np.random.default_rng(7), {})
    plan = _port_planner(scenario=sc).plan_round(
        0, np.random.default_rng(7), {})
    grp, grp0 = plan.groups[0], base.groups[0]
    lw = np.asarray(grp.agg.lane_weights)
    lw0 = np.asarray(grp0.agg.lane_weights)
    assert np.isclose(lw.sum(), 1.0)
    stale = [c for c in range(grp.lanes) if st.send_slow[grp.hops[0].ids[c]]]
    assert stale, "seed 3 must mark some cohort member send-slow"
    for c in range(grp.lanes):
        assert (lw[c] < lw0[c]) if c in stale else (lw[c] > lw0[c])


def test_rescale_agg_zeroes_dead_groups_and_renormalizes():
    from repro.core.plan import AggSpec as RefAgg
    from repro.core.scenario import _rescale_agg as ref_rescale
    from repro_torch.core.plan import AggSpec
    from repro_torch.core.scenario import _rescale_agg

    kw = dict(groups=((0, 1), (2, 3)), lane_weights=(0.5, 0.5, 0.5, 0.5),
              group_weights=(0.5, 0.5))
    out = _rescale_agg(AggSpec(**kw), np.array([1.0, 0.0, 0.0, 0.0]))
    assert out.lane_weights[0] == 1.0          # the survivor takes its group
    assert out.group_weights == (1.0, 0.0)     # the dead group zeroed
    with pytest.raises(ValueError, match="every lane"):
        _rescale_agg(AggSpec(**kw), np.zeros(4))
    # an uncollapsed spec (HierFAVG's edge iterations) keeps no group
    # weights, and an edge that lost every lane weighs nothing in its rows
    open_kw = dict(kw, group_weights=None)
    for factor in ([0.0, 0.0, 0.3, 1.0], [0.25, 1.0, 0.5, 0.5]):
        got = _rescale_agg(AggSpec(**open_kw), np.asarray(factor))
        want = ref_rescale(RefAgg(**open_kw), np.asarray(factor))
        assert got.lane_weights == want.lane_weights
        assert got.group_weights is want.group_weights is None
        got = _rescale_agg(AggSpec(**kw), np.asarray(factor))
        want = ref_rescale(RefAgg(**kw), np.asarray(factor))
        assert (got.lane_weights, got.group_weights) == (
            want.lane_weights, want.group_weights)


def test_inactive_scenario_is_identity():
    """An inactive scenario's ``plan_round`` is ``_plan_round`` plus the
    clock stamp: no extra draws and no rewrites."""
    algo = _port_planner(scenario={})
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    p_tpl = algo.plan_round(0, r1, {})
    p_raw = algo._plan_round(0, r2, {})
    assert r1.bit_generator.state == r2.bit_generator.state
    g_tpl, g_raw = p_tpl.groups[0], p_raw.groups[0]
    assert g_tpl.hops[0].ids == g_raw.hops[0].ids
    assert g_tpl.agg == g_raw.agg and g_tpl.lane_scale is None
    for a, b in zip(g_tpl.hops[0].plans, g_raw.hops[0].plans):
        np.testing.assert_array_equal(a, b)
    assert p_tpl.comm == p_raw.comm
    assert p_tpl.sim_seconds > 0 and p_raw.sim_seconds == 0.0


# ---------------------------------------------------------------------------
# the simulated clock


def test_sim_clock_closed_form():
    # rates 1, transfer 0.5: a cohort round is max(steps) + 0.5 per visit
    # + 2 * 0.5 for the cloud broadcast and upload
    algo = _port_planner(scenario={"transfer_seconds": 0.5})
    plan = algo._plan_round(0, np.random.default_rng(7), {})
    steps = [p.shape[0] for p in plan.groups[0].hops[0].plans]
    expect = max(steps) + 0.5 + 2 * 0.5
    assert np.isclose(algo.scenario.plan_seconds(plan), expect)
    got = algo.plan_round(0, np.random.default_rng(7), {})
    assert np.isclose(got.sim_seconds, expect)


def test_sim_clock_waits_for_slowest_rate_and_caps_at_threshold():
    from repro_torch.configs.base import ScenarioConfig
    from repro_torch.core.scenario import ScenarioState

    fast = ScenarioState(ScenarioConfig(), 8)
    slow = ScenarioState(ScenarioConfig(rate_min=0.25, rate_max=0.25), 8)
    capped = ScenarioState(ScenarioConfig(time_threshold=1.5), 8)
    plan = _port_planner(scenario={})._plan_round(
        0, np.random.default_rng(7), {})
    assert np.isclose(slow.plan_seconds(plan), 4 * fast.plan_seconds(plan))
    assert capped.plan_seconds(plan) == 1.5


# ---------------------------------------------------------------------------
# across the packages, exactly


@pytest.mark.parametrize("cfg", [
    FULL, {"train_slow_frac": 0.5, "seed": 1},
    {"send_slow_frac": 0.25, "rate_min": 0.2, "rate_max": 3.0, "seed": 9},
    {"train_slow_frac": 0.3, "send_slow_frac": 0.6, "seed": 4}])
def test_scenario_state_draws_are_the_reference(cfg):
    """``train_slow``, then ``send_slow``, then ``rates``, all from the
    scenario's own seed, in the reference's order."""
    from repro.configs.base import ScenarioConfig as RefScenario
    from repro.core.scenario import ScenarioState as RefState
    from repro_torch.configs.base import ScenarioConfig
    from repro_torch.core.scenario import ScenarioState

    for k in (8, 20, 100):
        ref = RefState(RefScenario(**cfg), k)
        port = ScenarioState(ScenarioConfig(**cfg), k)
        for name in ("train_slow", "send_slow", "rates"):
            a, b = getattr(ref, name), getattr(port, name)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("algo", ["fedavg", "fedsr", "hieravg", "ring"])
def test_transform_is_the_reference(algo):
    """The same untransformed plan and RNG state through each package's
    ``transform``: equal plans, dropped sets and RNG states after."""
    from repro.core.plan import Schedule as RefSchedule
    from repro_torch.core.plan import Schedule

    ref, port = _planners(algo, participation=0.75)
    for t in range(3):
        rr, pr = np.random.default_rng(t), np.random.default_rng(t)
        raw_ref, raw_port = ref._plan_round(t, rr, {}), port._plan_round(
            t, pr, {})
        ref_plan, ref_dropped = ref.scenario.transform(raw_ref, rr)
        port_plan, port_dropped = port.scenario.transform(raw_port, pr)
        assert ref_dropped == port_dropped
        assert rr.bit_generator.state == pr.bit_generator.state
        assert ref.scenario.draw_round(ref_plan, rr) == \
            port.scenario.draw_round(port_plan, pr)
        assert_schedules_equal(RefSchedule(plans=(ref_plan,)),
                               Schedule(plans=(port_plan,)))


@pytest.mark.parametrize("algo", ALGOS)
def test_scenario_schedules_and_block_arrays_are_the_reference(algo):
    """A 3-round block under ``FULL`` at participation 0.75: transformed
    plans, rebuilt comm (SCAFFOLD's two transfers a client, HierFAVG's per
    edge, the rings' shrunk laps), simulated seconds and RNG state equal,
    and the fused block arrays byte for byte (dead lanes at the dump row,
    SCAFFOLD's ``mw`` and ``frac`` over live lanes only, MOON's
    ``use_prev``)."""
    ref, port = _planners(algo, participation=0.75)
    rr, pr = np.random.default_rng(7), np.random.default_rng(7)
    rs = ref.plan_schedule(0, 3, rr, {})
    ps = port.plan_schedule(0, 3, pr, {})
    assert_schedules_equal(rs, ps)
    assert rr.bit_generator.state == pr.bit_generator.state
    np.testing.assert_array_equal(rs.visited(), ps.visited())
    assert any(p is None for plan in ps.plans for g in plan.groups
               for h in g.hops for p in h.plans)
    lrs = np.asarray([0.05, 0.04, 0.03])
    if algo == "hieravg":
        rxs = ref.engine._stack_hier_schedule(rs.plans, lrs)
        pxs = port.engine._stack_hier_schedule(ps.plans, lrs)
    else:
        seen = np.zeros(9, bool)
        seen[[0, 5]] = True
        variant = ps.plans[0].groups[0].variant
        rxs = ref.engine._stack_cohort_schedule(rs.plans, lrs, variant,
                                                {"seen": seen.copy()})
        pxs = port.engine._stack_cohort_schedule(ps.plans, lrs, variant,
                                                 {"seen": seen.copy()})
    assert sorted(rxs) == sorted(pxs)
    for k in pxs:
        assert rxs[k].dtype == pxs[k].dtype, k
        assert rxs[k].tobytes() == pxs[k].tobytes(), k
    if algo in ("moon", "scaffold"):
        for r, plan in enumerate(ps.plans):
            dead = np.asarray(plan.groups[0].lane_steps()) == 0
            assert (pxs["ids"][r][:len(dead)][dead] == 8).all()


def test_staged_ids_send_dead_lanes_to_the_cohort_dump_row():
    """Under a staged store a dead lane's dump row K goes through the
    block's fleet->cohort rowmap to the staged dump row V."""
    from repro_torch.core.state import rowmap_for

    _, port = _planners("moon", participation=0.75,
                        scenario={"drop_rate": 0.5})
    sched = port.plan_schedule(0, 2, np.random.default_rng(7), {})
    visited = sched.visited()
    rowmap = rowmap_for(visited, 8)
    xs = port.engine._stack_cohort_schedule(
        sched.plans, [0.05, 0.05], "moon",
        {"seen": np.zeros(9, bool), "_rowmap": rowmap})
    V = len(visited)
    for r, plan in enumerate(sched.plans):
        grp = plan.groups[0]
        live = np.asarray(grp.lane_steps()) > 0
        assert (~live).any()
        ids = xs["ids"][r][:grp.lanes]
        assert (ids[~live] == V).all()
        assert ids[live].tolist() == rowmap[
            np.asarray(grp.hops[0].ids)[live]].tolist()


# ---------------------------------------------------------------------------
# whole runs against the reference


def _ref_trainer(rm, rfl):
    from repro.core.local import LocalTrainer

    if "ref_trainer" not in _RUNS:
        _RUNS["ref_trainer"] = LocalTrainer(rm, rfl)
    tr = _RUNS["ref_trainer"]
    tr.h2d_bytes = tr.dispatches = 0
    return tr


def _ref_run(monkeypatch, algo, engine, **kw):
    """The reference's ``run_experiment`` under ``FULL`` on the shared
    trainer: its result, planned blocks and the trainer's meters."""
    import repro.core.executor as ref_executor

    (rm, rfl), _ = configs(SMALL, algorithm=algo, engine=engine,
                           scenario=FULL, **RUN_FL)
    (rtr, rte), _ = _task()
    with monkeypatch.context() as m:
        tr = _ref_trainer(rm, rfl)
        m.setattr(ref_executor, "LocalTrainer", lambda *a, **k: tr)
        plans = record_plans(m, "repro.core.algorithms")
        res = ref_executor.run_experiment(
            task="mnist_like", model_cfg=rm, fl=rfl, train=rtr, test=rte,
            eval_every=2, **kw)
    return res, plans, (tr.h2d_bytes, tr.dispatches)


def _init():
    if "init" not in _RUNS:
        rm, _ = configs(SMALL)[0]
        _RUNS["init"] = jax_init(rm, RUN_FL["seed"])
    return _RUNS["init"]


def _port_run(algo, engine, eval_every=2, scenario=FULL, record=None,
              **kw):
    """A port run at ``RUN_FL`` from the reference's initial weights
    (cached by its arguments unless its plans are recorded)."""
    from repro_torch.core.executor import run_experiment

    key = (algo, engine, eval_every, repr(scenario), repr(sorted(kw.items())))
    if record is None and key in _RUNS:
        return _RUNS[key]
    fl_kw = dict(RUN_FL, **{k: v for k, v in kw.items()
                            if k not in ("stop_after", "checkpoint_dir",
                                         "checkpoint_every", "resume")})
    _, (pm, pfl) = configs(SMALL, algorithm=algo, engine=engine,
                           scenario=scenario, **fl_kw)
    _, (ptr, pte) = _task()
    run_kw = {k: v for k, v in kw.items() if k not in fl_kw}
    with pytest.MonkeyPatch.context() as m:
        plans = record_plans(m, "repro_torch.core.algorithms")
        res = run_experiment(task="mnist_like", model_cfg=pm, fl=pfl,
                             train=ptr, test=pte, init_params=_init(),
                             device="cpu", eval_every=eval_every, **run_kw)
    if record is not None:
        record.extend(plans)
    else:
        _RUNS[key] = res
    return res


REF_CASES = [(a, "fused") for a in ALGOS] + [
    ("fedsr", "batched"), ("hieravg", "batched"), ("moon", "batched"),
    ("scaffold", "batched"), ("fedavg", "sequential"),
    ("ring", "sequential")]


@pytest.mark.parametrize("algo,engine", REF_CASES,
                         ids=[f"{a}-{e}" for a, e in REF_CASES])
def test_scenario_run_matches_reference(monkeypatch, algo, engine):
    ref, ref_plans, (h2d, dispatches) = _ref_run(monkeypatch, algo, engine)
    plans = []
    port = _port_run(algo, engine, record=plans)
    assert len(plans) == len(ref_plans) == 1
    for (ta, sa, ra), (tb, sb, rb) in zip(ref_plans, plans):
        assert ta == tb and ra == rb
        assert_schedules_equal(sa, sb)
    # the scenario did drop, truncate and decay in this run
    groups = [g for _, s, _ in plans for p in s.plans for g in p.groups]
    assert any(p is None for g in groups for h in g.hops for p in h.plans)
    _, (_, pte) = _task()
    assert_histories_equal(ref, port, len(pte))
    assert port.history[-1].comm["sim_seconds"] > 0
    assert port.h2d_bytes == h2d and port.dispatches == dispatches
    assert port.peak_device_bytes == ref.peak_device_bytes
    assert_trees_close(port.final_model, ref.final_model, atol=1e-4)


# ---------------------------------------------------------------------------
# inside the port


def _bit_equal(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def _max_diff(a, b) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


@pytest.mark.parametrize("algo", ALGOS)
def test_engines_agree_under_the_scenario(algo):
    """Batched bit-equal to fused, sequential within 1e-6 (its unmasked
    update and ordered reduce, ROADMAP C2), the same comm and clock; and
    the fused engine's chunked block bit-equal to its per-round driver in
    one call."""
    runs = {e: _port_run(algo, e) for e in ENGINES}
    fused = runs["fused"]
    assert _bit_equal(runs["batched"].final_model, fused.final_model)
    assert _max_diff(runs["sequential"].final_model,
                     fused.final_model) <= 1e-6
    for e in ENGINES:
        assert runs[e].history[-1].comm == fused.history[-1].comm, e
    per_round = _port_run(algo, "fused", eval_every=1)
    assert _bit_equal(per_round.final_model, fused.final_model)
    assert per_round.history[-1].comm == fused.history[-1].comm
    assert (fused.dispatches, per_round.dispatches) == (1, 2)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("algo", ["moon", "scaffold"])
def test_dead_lanes_stay_out_of_the_state(algo, engine):
    """A dropped lane still runs its masked steps, but its trained row
    goes to the dump row: it never lands in a client's row, the client
    stays unseen, and SCAFFOLD's server variate averages live lanes only
    (``mw``, ``frac``). Each engine's state after two rounds against the
    reference's (``engine_parity``'s algorithm API), rows within 1e-4."""
    import jax.numpy as jnp
    from repro.core.comm import CommMeter as RefMeter
    from repro_torch.core.comm import CommMeter
    from repro_torch.models.small import params_from_numpy
    from repro_torch.utils.tree import ravel_params

    sc = {"drop_rate": 0.5, "train_slow_frac": 0.25, "seed": 2}
    ref, port = _planners(algo, scenario=sc, engine=engine)
    w0 = jax_init(configs(SMALL)[0][0], 0)
    rw = {k: jnp.asarray(v) for k, v in w0.items()}
    pw = ravel_params(params_from_numpy(w0, CPU))
    rstate, pstate = {}, {}
    rr, pr = np.random.default_rng(5), np.random.default_rng(5)
    dead = set()
    for t in range(2):
        lrs = np.asarray([0.05])
        rw, rstate = ref.run_schedule(rw, t, lrs, rr, RefMeter(model_bytes=1), rstate)
        sched = port.plan_schedule(t, 1, pr, pstate)
        grp = sched.plans[0].groups[0]
        live = np.asarray(grp.lane_steps()) > 0
        dead |= set(np.asarray(grp.hops[0].ids)[~live].tolist())
        pw = port.dispatch_block(sched, pw, lrs, pstate)
        port.finish_block(sched, pstate, CommMeter(model_bytes=1))
    assert dead, "the drop rate must kill some lane"
    np.testing.assert_array_equal(rstate["seen"], pstate["seen"])
    field = "prev" if algo == "moon" else "ci"
    stack = pstate[field]
    never = sorted(i for i in dead if not pstate["seen"][i])
    assert never, "some dropped client must stay unseen"
    assert not stack[never].any()              # rows still the zeros
    ref_rows = np.concatenate(
        [np.asarray(rstate[field][k]).reshape(9, -1)
         for k, _ in port.trainer.layout], axis=1)
    np.testing.assert_allclose(stack[:8].numpy(), ref_rows[:8], atol=1e-4)
    if algo == "scaffold":
        ref_c = np.concatenate([np.asarray(rstate["c"][k]).reshape(-1)
                                for k, _ in port.trainer.layout])
        np.testing.assert_allclose(pstate["c"].numpy(), ref_c, atol=1e-4)


@pytest.mark.parametrize("algo", ["moon", "scaffold"])
def test_staged_store_and_prefetch_are_bit_equal_under_the_scenario(algo):
    """``store="host"``, ``prefetch=1`` against ``store="device"``,
    ``prefetch=0``: the dump row of each dead lane goes through the rowmap
    to the staged carry's dump row, so the runs agree bit for bit."""
    kw = dict(participation=0.5, rounds=3)
    base = _port_run(algo, "fused", eval_every=1, **kw)
    staged = _port_run(algo, "fused", eval_every=1, store="host", prefetch=1,
                       **kw)
    assert _bit_equal(staged.final_model, base.final_model)
    assert [(r.round, r.accuracy, r.comm, r.lr) for r in staged.history] \
        == [(r.round, r.accuracy, r.comm, r.lr) for r in base.history]
    assert staged.peak_device_bytes < base.peak_device_bytes


def test_fedsr_resume_under_the_scenario_is_exact(tmp_path):
    """FedSR under ``FULL``, stopped after round 2 and resumed from its
    checkpoint (the RNG state carries the per-round drop and staleness
    draws; the slow subsets come from the scenario's own seed), equals
    the uninterrupted run: round, accuracy, comm (``sim_seconds`` too),
    lr and the final model (the C6 fields)."""
    kw = dict(rounds=4)
    full = _port_run("fedsr", "fused", **kw)
    ck = str(tmp_path / "ck")
    _port_run("fedsr", "fused", record=[], checkpoint_dir=ck,
              checkpoint_every=2, stop_after=2, **kw)
    resumed = _port_run("fedsr", "fused", record=[], checkpoint_dir=ck,
                        resume=True, **kw)
    assert [(r.round, r.accuracy, r.comm, r.lr) for r in resumed.history] \
        == [(r.round, r.accuracy, r.comm, r.lr) for r in full.history]
    assert _bit_equal(resumed.final_model, full.final_model)


def test_default_scenario_run_is_the_plain_planners():
    """``ScenarioConfig()`` runs exactly as the planners did before the
    scenario seam (``_plan_round`` plus the clock stamp): the same model
    bit for bit, comm, and RNG state after the block."""
    from repro_torch.core import algorithms

    def plain_plan_round(self, t, rng, state):
        plan = self._plan_round(t, rng, state)
        return dataclasses.replace(
            plan, sim_seconds=self.scenario.plan_seconds(plan))

    for algo in ("fedsr", "hieravg"):
        now, before = [], []
        run = _port_run(algo, "fused", scenario={}, record=now)
        with pytest.MonkeyPatch.context() as m:
            m.setattr(algorithms._Planner, "plan_round", plain_plan_round)
            old = _port_run(algo, "fused", scenario={}, record=before)
        assert _bit_equal(run.final_model, old.final_model)
        assert run.history[-1].comm == old.history[-1].comm
        assert now[-1][2] == before[-1][2]
