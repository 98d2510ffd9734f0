"""The port's robust reducers (``core/robust.py``, ``AggSpec.reducer`` and
its ``reduce_kwargs``, ``_Planner._mark_agg``, the robust reduce of every
engine) against the JAX package's.

* Units, case for case with the robust units of ``tests/test_adversary.py``,
  each also against the reference's ``robust_agg`` on the same numpy
  inputs (median bit-equal, trimmed mean within 1e-6, Krum the same
  selected lane): invalid lanes never touch the statistic; the
  coordinatewise median; the trimmed mean drops the extremes; Krum
  selects an honest lane; the group collapse stays linear; a ghost-padded
  median through ``train_many``. Also the edge cases (an empty group, a
  single lane, Krum's ``m = 1``), a result that is never a view of a lane,
  ``AggSpec``'s validation and ``reduce_kwargs``, and the reducer stamp.
* Properties (Hypothesis, or fixed examples without it): permutation
  invariance, the median and the trimmed mean within the valid extremes,
  Krum's honest selection.
* Whole runs against the reference under ``sign_flip``: FedAvg, FedSR and
  HierFAVG x the three reducers x the three engines: plans with the
  stamped reducer, the RNG state after each block, comm, ``h2d_bytes``
  and ``dispatches`` exact, final models within 1e-4 (ROADMAP C8); the
  fused block's stacked arrays byte for byte; inside the port batched
  bit-equal to fused and sequential within 1e-6. Compositions: median
  with ``drop_rate=0.3`` (FedAvg and FedSR, batched and fused), a chunked
  fused block equal to the per-round driver in one call, MOON and
  SCAFFOLD with the median, and ``store="host"``, ``prefetch=1`` bit-equal
  to ``store="device"``.

The reference's runs share one ``LocalTrainer``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (
    SMALL, assert_histories_equal, assert_schedules_equal,
    assert_trees_close, configs, jax_init, mnist_tasks, record_plans,
)

try:
    from hypothesis import given, settings, strategies as st
    HAS_HYPOTHESIS = True
except ModuleNotFoundError:
    HAS_HYPOTHESIS = False

CPU = torch.device("cpu")
ENGINES = ("fused", "batched", "sequential")
REDUCERS = ("median", "trimmed_mean", "krum")
SIGNFLIP = {"frac": 0.25, "kind": "sign_flip"}
# the whole-run setting of test_torch_adversary (K=8, M=2, R=2, E=1, batch
# 8, momentum 0.5, dirichlet alpha 0.5), two rounds in one block; the
# trimmed mean trims a quarter a side, Krum assumes one attacker
RUN_FL = dict(num_devices=8, num_edges=2, ring_rounds=2, local_epochs=1,
              batch_size=8, momentum=0.5, partition="dirichlet", alpha=0.5,
              seed=3, rounds=2, trim_frac=0.25, krum_f=1)
# Krum's scores sum |x_i|^2 + |x_j|^2 - 2 x_i . x_j over every coordinate,
# each package in its own order; two scores closer than this (relative)
# are a tie that rounding may break either way (ROADMAP C1)
KRUM_TIE = 1e-5

_RUNS = {}


# ---------------------------------------------------------------------------
# core.robust units


def _port_reduce(vals, w, reducer, trim_frac=0.0, krum_f=0):
    """The port's reduce of one group of lanes ``vals`` (C, P) under lane
    weights ``w``."""
    from repro_torch.core.robust import robust_agg

    return robust_agg(torch.from_numpy(np.asarray(vals, np.float32)),
                      np.asarray(w, np.float32)[None, :],
                      np.ones(1, np.float32), reducer, trim_frac,
                      krum_f).numpy()


def _reduce(vals, w, reducer, trim_frac=0.0, krum_f=0):
    """The port's and the reference's reduce of one group of lanes
    ``vals`` (C, P) under lane weights ``w``: ``(port, reference)``."""
    import jax.numpy as jnp
    from repro.core.robust import robust_agg as ref_agg

    ref = ref_agg({"w": jnp.asarray(vals, jnp.float32)},
                  np.asarray(w, np.float32)[None, :], np.ones(1, np.float32),
                  reducer, trim_frac, krum_f)
    return (_port_reduce(vals, w, reducer, trim_frac, krum_f),
            np.asarray(ref["w"]))


def _assert_reference(port, ref, reducer):
    """The port's reduce against the reference's: the median bit-equal,
    the trimmed mean within 1e-6, Krum the same selected lane (a one-hot
    contraction, so the same lane is the same values)."""
    if reducer == "trimmed_mean":
        np.testing.assert_allclose(port, ref, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("reducer,tf,kf", [("median", 0.0, 0),
                                           ("trimmed_mean", 0.25, 0),
                                           ("krum", 0.0, 1)])
def test_invalid_lanes_never_touch_the_statistic(reducer, tf, kf):
    """Garbage in a weight-0 lane (a ghost, a ring tail, a dropped client)
    moves nothing; reducing the valid lanes alone gives the same
    statistic."""
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(5, 7)).astype(np.float32)
    w = np.array([0.3, 0.0, 0.2, 0.5, 0.0], np.float32)
    clean, ref = _reduce(vals, w, reducer, tf, kf)
    _assert_reference(clean, ref, reducer)
    poisoned = vals.copy()
    poisoned[1] = 1e9
    poisoned[4] = -1e9
    got, ref = _reduce(poisoned, w, reducer, tf, kf)
    np.testing.assert_array_equal(clean, got)
    _assert_reference(got, ref, reducer)
    alone, _ = _reduce(vals[[0, 2, 3]], w[[0, 2, 3]], reducer, tf, kf)
    np.testing.assert_allclose(clean, alone, atol=1e-6, rtol=1e-6)


def test_median_is_the_coordinatewise_median():
    vals = np.array([[1.0, 10.0], [3.0, -2.0], [2.0, 4.0]], np.float32)
    for v in (vals, np.vstack([vals, [[7.0, 0.0]]])):
        got, ref = _reduce(v, np.ones(len(v)), "median")
        np.testing.assert_allclose(got, np.median(v, axis=0))
        np.testing.assert_array_equal(got, ref)


def test_trimmed_mean_drops_the_extremes():
    vals = np.array([[-100.0], [1.0], [2.0], [3.0], [100.0]], np.float32)
    got, ref = _reduce(vals, np.ones(5), "trimmed_mean", trim_frac=0.2)
    np.testing.assert_allclose(got, [2.0])
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def _selected(vals, out) -> int:
    """The lane a Krum output is (its nearest lane, at distance 0)."""
    d = np.linalg.norm(vals - out, axis=1)
    assert d.min() < 1e-5, "the krum output is not a single lane"
    return int(d.argmin())


def test_krum_selects_an_honest_lane_under_minority_attack():
    rng = np.random.default_rng(1)
    C, f = 10, 3
    honest = rng.normal(0.0, 0.1, size=(C - f, 16)).astype(np.float32)
    attack = rng.normal(50.0, 0.1, size=(f, 16)).astype(np.float32)
    vals = np.vstack([attack, honest])      # attackers first, on purpose
    got, ref = _reduce(vals, np.ones(C), "krum", krum_f=f)
    assert _selected(vals, got) >= f, "krum picked an attacked lane"
    assert _selected(vals, got) == _selected(vals, ref)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("reducer", REDUCERS)
def test_group_collapse_stays_linear_in_group_weights(reducer):
    """Two groups reduce independently; the (G,) group weights collapse
    the per-group rows linearly; ``gw=None`` returns the (G, P) rows."""
    import jax.numpy as jnp
    from repro.core.robust import robust_agg as ref_agg
    from repro_torch.core.robust import robust_agg

    rng = np.random.default_rng(2)
    vals = rng.normal(size=(6, 4)).astype(np.float32)
    wm = np.zeros((2, 6), np.float32)
    wm[0, :3] = 1.0
    wm[1, 3:] = 1.0
    gw = np.array([0.25, 0.75], np.float32)
    lanes = torch.from_numpy(vals)
    rows = robust_agg(lanes, wm, None, reducer, 0.25, 0).numpy()
    got = robust_agg(lanes, wm, gw, reducer, 0.25, 0).numpy()
    np.testing.assert_allclose(got, gw @ rows, atol=1e-6)
    for g in range(2):
        one, _ = _reduce(vals, wm[g], reducer, 0.25, 0)
        np.testing.assert_array_equal(rows[g], one)
    if reducer == "median":
        want = (0.25 * np.median(vals[:3], axis=0)
                + 0.75 * np.median(vals[3:], axis=0))
        np.testing.assert_allclose(got, want, atol=1e-6)
    for g_w, out in ((None, rows), (gw, got)):
        ref = ref_agg({"w": jnp.asarray(vals)}, wm, g_w, reducer, 0.25, 0)
        _assert_reference(out, np.asarray(ref["w"]), reducer)


@pytest.mark.parametrize("reducer", REDUCERS)
def test_edge_groups_reduce_as_the_reference(reducer):
    """A group with no valid lane gives a zero row (a whole dropped edge,
    at group weight 0); a single valid lane reduces to that lane (Krum's
    ``m = 1`` has no valid pair, scores ``_BIG`` and is chosen); the
    result is a new tensor, never a view of a lane."""
    import jax.numpy as jnp
    from repro.core.robust import robust_agg as ref_agg
    from repro_torch.core.robust import robust_agg

    rng = np.random.default_rng(4)
    vals = rng.normal(size=(4, 5)).astype(np.float32)
    wm = np.array([[0, 0, 0, 0], [0, 0.7, 0, 0], [1, 1, 1, 1]], np.float32)
    lanes = torch.from_numpy(vals.copy())
    rows = robust_agg(lanes, wm, None, reducer, 0.25, 1)
    np.testing.assert_array_equal(rows[0].numpy(), np.zeros(5, np.float32))
    np.testing.assert_array_equal(rows[1].numpy(), vals[1])
    ref = np.asarray(ref_agg({"w": jnp.asarray(vals)}, wm, None, reducer,
                             0.25, 1)["w"])
    _assert_reference(rows.numpy(), ref, reducer)
    one = torch.from_numpy(vals[:1].copy())
    out = robust_agg(one, np.ones((1, 1), np.float32),
                     np.ones(1, np.float32), reducer, 0.25, 1)
    assert out.data_ptr() != one.data_ptr()
    out += 1.0
    np.testing.assert_array_equal(one.numpy(), vals[:1])
    with pytest.raises(ValueError, match="unknown robust reducer"):
        robust_agg(lanes, wm, None, "weighted_mean")


# ---------------------------------------------------------------------------
# AggSpec and the reducer stamp


def test_agg_spec_reduce_kwargs_are_the_reference():
    from repro.core.plan import AggSpec as RefAgg
    from repro_torch.core.plan import AggSpec

    for cls in (AggSpec, RefAgg):
        with pytest.raises(ValueError, match="unknown reducer"):
            cls(groups=((0,),), lane_weights=(1.0,), reducer="mode")
    kw = dict(groups=((0, 1), (2,)), lane_weights=(0.25, 0.75, 1.0))
    for reducer, gw in [("weighted_mean", (0.4, 0.6)), ("median", (0.4, 0.6)),
                        ("krum", None), ("trimmed_mean", (0.4, 0.6))]:
        spec = dict(kw, group_weights=gw, reducer=reducer, trim_frac=0.2,
                    krum_f=2)
        port = AggSpec(**spec).reduce_kwargs(4)
        ref = RefAgg(**spec).reduce_kwargs(4)
        assert sorted(port) == sorted(ref)
        for k, v in ref.items():
            if isinstance(v, np.ndarray):
                assert port[k].dtype == v.dtype and port[k].tobytes() == \
                    v.tobytes(), k
            else:
                assert port[k] == v, k


def _task():
    if "task" not in _RUNS:
        _RUNS["task"] = mnist_tasks(train_per_class=10, test_per_class=2)
    return _RUNS["task"]


def _clients(pkg):
    import importlib

    make_clients = importlib.import_module(f"{pkg}.data.pipeline").make_clients
    tasks = _task()
    train = tasks[0][0] if pkg == "repro" else tasks[1][0]
    return make_clients(train, scheme="dirichlet", num_devices=8,
                        rng=np.random.default_rng(0), alpha=0.5)


def _planners(algo, **overrides):
    """The ``algo`` planner of each package over identical clients."""
    from repro.core.algorithms import make_algorithm as ref_make_algorithm
    from repro.core.local import LocalTrainer as RefTrainer
    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.core.local import LocalTrainer

    kw = dict(RUN_FL, algorithm=algo, engine="fused", participation=0.75)
    kw.update(overrides)
    (rm, rfl), (pm, pfl) = configs(SMALL, **kw)
    return (ref_make_algorithm(algo, RefTrainer(rm, rfl), _clients("repro"),
                               rfl),
            make_algorithm(algo, LocalTrainer(pm, pfl, CPU),
                           _clients("repro_torch"), pfl))


def test_weighted_mean_plans_are_untouched_and_robust_ones_stamped():
    """``_mark_agg`` returns a ``weighted_mean`` plan as it is and stamps a
    robust reducer (with its knobs) on every ``AggSpec``; neither draws."""
    _, plain = _planners("hieravg")
    plan = plain._plan_round(0, np.random.default_rng(7), {})
    assert plain._mark_agg(plan) is plan
    _, robust = _planners("hieravg", reducer="krum")
    r0, r1 = np.random.default_rng(7), np.random.default_rng(7)
    base = plain.plan_round(0, r0, {})
    marked = robust.plan_round(0, r1, {})
    assert r0.bit_generator.state == r1.bit_generator.state
    assert len(marked.groups) == len(base.groups) > 1
    for g, g0 in zip(marked.groups, base.groups):
        assert g.agg == dataclasses.replace(g0.agg, reducer="krum",
                                            trim_frac=0.25, krum_f=1)
        assert [h.ids for h in g.hops] == [h.ids for h in g0.hops]


@pytest.mark.parametrize("algo,scenario", [
    ("fedavg", {}), ("fedsr", {}), ("hieravg", {}),
    ("fedavg", {"drop_rate": 0.5, "seed": 4}),
    ("fedsr", {"drop_rate": 0.5, "seed": 4})])
def test_stacked_robust_schedule_is_the_reference(algo, scenario):
    """The fused block's arrays under a robust reducer, byte for byte the
    reference's: ``aggw``/``aggg`` (cohort, zero rows padding the block's
    largest group count) or ``gwv`` (HierFAVG) in place of ``aggv``."""
    ref, port = _planners(algo, reducer="median", scenario=scenario,
                          adversary=SIGNFLIP)
    rr, pr = np.random.default_rng(3), np.random.default_rng(3)
    rs = ref.plan_schedule(0, 3, rr, {})
    ps = port.plan_schedule(0, 3, pr, {})
    assert_schedules_equal(rs, ps)
    assert rr.bit_generator.state == pr.bit_generator.state
    assert all(g.agg.reducer == "median" for p in ps.plans for g in p.groups)
    lrs = np.asarray([0.05, 0.04, 0.03])
    if algo == "hieravg":
        rxs = ref.engine._stack_hier_schedule(rs.plans, lrs)
        pxs = port.engine._stack_hier_schedule(ps.plans, lrs)
        assert "gwv" in pxs and "aggv" not in pxs
    else:
        rxs = ref.engine._stack_cohort_schedule(rs.plans, lrs, "plain", {})
        pxs = port.engine._stack_cohort_schedule(ps.plans, lrs)
        assert "aggw" in pxs and "aggg" in pxs and "aggv" not in pxs
    assert sorted(rxs) == sorted(pxs)
    for k in pxs:
        assert rxs[k].dtype == pxs[k].dtype, k
        assert rxs[k].tobytes() == pxs[k].tobytes(), k


# ---------------------------------------------------------------------------
# properties (of the port alone: the units above hold it to the reference)

def _krum_tied(vals, w, krum_f) -> bool:
    """Whether the two lowest Krum scores of the valid lanes lie within
    rounding of each other (then the lane order picks, ROADMAP C1)."""
    from repro_torch.core.robust import krum_scores

    mask = torch.from_numpy(np.asarray(w) > 0)[None]
    s = np.sort(krum_scores(torch.from_numpy(vals), mask,
                            krum_f)[0].numpy())
    s = s[np.isfinite(s)]
    return len(s) > 1 and s[1] - s[0] <= KRUM_TIE * max(abs(s[0]), 1e-30)


def _check_permutation(seed, C):
    """Every reducer gives the same result for permuted lanes. Krum is left
    out where its two lowest scores tie within rounding: the first minimum
    in lane order is chosen, as in the reference (ROADMAP C1)."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(C, 6)).astype(np.float32)
    w = (rng.random(C) > 0.3).astype(np.float32) * 0.7
    if w.sum() == 0:
        w[0] = 1.0
    perm = rng.permutation(C)
    for reducer, tf, kf in (("median", 0.0, 0), ("trimmed_mean", 0.25, 0),
                            ("krum", 0.0, 1)):
        if reducer == "krum" and _krum_tied(vals, w, kf):
            continue
        a = _port_reduce(vals, w, reducer, tf, kf)
        b = _port_reduce(vals[perm], w[perm], reducer, tf, kf)
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)


def _check_bounded(seed, C, tf):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(C, 6)).astype(np.float32)
    w = (rng.random(C) > 0.3).astype(np.float32)
    if w.sum() == 0:
        w[0] = 1.0
    valid = vals[w > 0]
    lo, hi = valid.min(axis=0), valid.max(axis=0)
    for reducer in ("median", "trimmed_mean"):
        out = _port_reduce(vals, w, reducer, trim_frac=tf)
        assert np.all(out >= lo - 1e-5) and np.all(out <= hi + 1e-5)


def _check_krum_honest(seed, C):
    rng = np.random.default_rng(seed)
    f = max(1, C // 2 - 2)
    honest = rng.normal(0.0, 0.1, size=(C - f, 8)).astype(np.float32)
    attack = rng.normal(30.0, 0.1, size=(f, 8)).astype(np.float32)
    vals = np.vstack([attack, honest])
    out = _port_reduce(vals, np.ones(C), "krum", krum_f=f)
    assert _selected(vals, out) >= f


if HAS_HYPOTHESIS:

    @given(st.integers(0, 2**31 - 1), st.integers(3, 9))
    @settings(max_examples=25, deadline=None)
    def test_reducers_are_lane_permutation_invariant(seed, C):
        _check_permutation(seed, C)

    @given(st.integers(0, 2**31 - 1), st.integers(2, 9),
           st.floats(0.0, 0.45))
    @settings(max_examples=25, deadline=None)
    def test_median_trimmed_bounded_by_valid_extremes(seed, C, tf):
        _check_bounded(seed, C, tf)

    @given(st.integers(0, 2**31 - 1), st.integers(6, 12))
    @settings(max_examples=25, deadline=None)
    def test_krum_honest_selection_property(seed, C):
        _check_krum_honest(seed, C)

else:

    @pytest.mark.parametrize("seed,C", [(0, 4), (1, 3), (2, 9), (3, 6)])
    def test_reducers_are_lane_permutation_invariant(seed, C):
        _check_permutation(seed, C)

    @pytest.mark.parametrize("seed,C,tf", [(0, 2, 0.0), (1, 5, 0.2),
                                           (2, 9, 0.45)])
    def test_median_trimmed_bounded_by_valid_extremes(seed, C, tf):
        _check_bounded(seed, C, tf)

    @pytest.mark.parametrize("seed,C", [(0, 6), (1, 9), (2, 12)])
    def test_krum_honest_selection_property(seed, C):
        _check_krum_honest(seed, C)


def test_c1_tie_is_the_first_minimum():
    """The reference's failing Hypothesis case (seed 0, C = 4, one
    attacker assumed; ROADMAP C1): two lanes tie exactly, and the port
    picks the first of them as the reference does, so the permuted stack
    may pick the other."""
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(4, 6)).astype(np.float32)
    w = (rng.random(4) > 0.3).astype(np.float32) * 0.7
    if w.sum() == 0:
        w[0] = 1.0
    got, ref = _reduce(vals, w, "krum", krum_f=1)
    np.testing.assert_array_equal(got, ref)
    from repro_torch.core.robust import krum_scores

    s = krum_scores(torch.from_numpy(vals), torch.from_numpy(w > 0)[None],
                    1)[0]
    best = torch.nonzero(s == s.min()).flatten().tolist()
    assert _selected(vals, got) == best[0]


# ---------------------------------------------------------------------------
# a ghost-padded median through train_many


def test_ghost_padded_median_matches_unpadded():
    """Ghost lanes (all-invalid, weight-0 columns of the uncollapsed
    matrix) fall out of the median: ``train_many`` over ``pad_to=C+2``
    equals the unpadded call bit for bit, and the reference's call within
    1e-5."""
    import jax
    from repro.core.local import LocalTrainer as RefTrainer
    from repro.data.pipeline import ClientData as RefClient
    from repro.data.pipeline import stack_plans as ref_stack_plans
    from repro.utils.tree import tree_broadcast
    from repro_torch.core.local import LocalTrainer
    from repro_torch.data.pipeline import (
        ClientData, plan_epoch_indices, stack_plans,
    )
    from repro_torch.utils.tree import ravel_params, unravel

    (rm, rfl), (pm, pfl) = configs(SMALL, batch_size=8, momentum=0.5)
    (_, _), (train, _) = mnist_tasks(train_per_class=12, test_per_class=2)
    idx = np.random.default_rng(0).permutation(len(train.labels))
    sizes, off, clients = (5, 17, 10), 0, []
    for cid, s in enumerate(sizes):
        clients.append(ClientData(cid, train.images[idx[off:off + s]],
                                  train.labels[idx[off:off + s]]))
        off += s
    rng = np.random.default_rng(3)
    plans = [plan_epoch_indices(c, 8, 1, rng) for c in clients]
    init = jax_init(rm, 0)
    w0 = ravel_params({k: torch.tensor(v) for k, v in init.items()})
    trainer = LocalTrainer(pm, pfl, CPU)
    lane_w = np.array([0.2, 0.5, 0.3], np.float32)
    C, outs = len(clients), {}
    for pad in (C, C + 2):
        batches, valid = stack_plans(clients, plans, pad_to=pad)
        agg = np.zeros((1, pad), np.float32)
        agg[0, :C] = lane_w
        outs[pad] = trainer.train_many(
            w0.repeat(pad, 1), batches, valid, lr=0.05, agg=agg,
            agg_gw=np.ones(1, np.float32), reducer="median")
    assert torch.equal(outs[C], outs[C + 2])
    ref_tr = RefTrainer(rm, rfl)
    ref_clients = [RefClient(c.client_id, c.images, c.labels)
                   for c in clients]
    batches, valid = ref_stack_plans(ref_clients, plans, pad_to=C + 2)
    agg = np.zeros((1, C + 2), np.float32)
    agg[0, :C] = lane_w
    ref = ref_tr.train_many(
        tree_broadcast({k: jax.numpy.asarray(v) for k, v in init.items()},
                       C + 2), batches, valid, lr=0.05, agg=agg,
        agg_gw=np.ones(1, np.float32), reducer="median")
    assert_trees_close(unravel(outs[C + 2], trainer.layout), ref, atol=1e-5)


# ---------------------------------------------------------------------------
# whole runs


def _init():
    if "init" not in _RUNS:
        rm, _ = configs(SMALL)[0]
        _RUNS["init"] = jax_init(rm, RUN_FL["seed"])
    return _RUNS["init"]


def _ref_run(monkeypatch, algo, engine, reducer, adversary, scenario):
    """The reference's ``run_experiment`` on the shared trainer: its
    result, planned blocks and the trainer's meters."""
    import repro.core.executor as ref_executor
    from repro.core.local import LocalTrainer

    (rm, rfl), _ = configs(SMALL, algorithm=algo, engine=engine,
                           reducer=reducer, adversary=adversary,
                           scenario=scenario, **RUN_FL)
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


def _port_run(algo, engine, reducer, adversary=SIGNFLIP, scenario=None,
              eval_every=2, **fl_kw):
    """A cached port run at ``RUN_FL`` from the reference's initial
    weights: ``(result, recorded blocks)``."""
    from repro_torch.core.executor import run_experiment

    key = (algo, engine, reducer, repr(adversary), repr(scenario),
           eval_every, repr(sorted(fl_kw.items())))
    if key not in _RUNS:
        _, (pm, pfl) = configs(SMALL, algorithm=algo, engine=engine,
                               reducer=reducer, adversary=adversary,
                               scenario=scenario or {},
                               **dict(RUN_FL, **fl_kw))
        _, (ptr, pte) = _task()
        with pytest.MonkeyPatch.context() as m:
            plans = record_plans(m, "repro_torch.core.algorithms")
            res = run_experiment(task="mnist_like", model_cfg=pm, fl=pfl,
                                 train=ptr, test=pte, init_params=_init(),
                                 device="cpu", eval_every=eval_every)
        _RUNS[key] = (res, plans)
    return _RUNS[key]


def _assert_matches_reference(monkeypatch, algo, engine, reducer,
                              adversary=SIGNFLIP, scenario=None):
    ref, ref_plans, (h2d, dispatches) = _ref_run(
        monkeypatch, algo, engine, reducer, adversary, scenario or {})
    port, plans = _port_run(algo, engine, reducer, adversary, scenario)
    assert len(plans) == len(ref_plans) == 1
    for (ta, sa, ra), (tb, sb, rb) in zip(ref_plans, plans):
        assert ta == tb and ra == rb
        assert_schedules_equal(sa, sb)
        assert all(g.agg.reducer == reducer for p in sb.plans
                   for g in p.groups)
    _, (_, pte) = _task()
    assert_histories_equal(ref, port, len(pte))
    assert port.h2d_bytes == h2d and port.dispatches == dispatches
    assert_trees_close(port.final_model, ref.final_model, atol=1e-4)
    for v in port.final_model.values():
        assert torch.isfinite(v).all()


REF_CASES = [(a, r, e) for a in ("fedavg", "fedsr", "hieravg")
             for r in REDUCERS for e in ENGINES]


@pytest.mark.parametrize("algo,reducer,engine", REF_CASES,
                         ids=["-".join(c) for c in REF_CASES])
def test_robust_run_matches_reference(monkeypatch, algo, reducer, engine):
    _assert_matches_reference(monkeypatch, algo, engine, reducer)


def _bit_equal(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def _max_diff(a, b) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


@pytest.mark.parametrize("reducer", REDUCERS)
@pytest.mark.parametrize("algo", ["fedavg", "fedsr", "hieravg"])
def test_engines_agree_under_a_robust_reduce(algo, reducer):
    """Batched bit-equal to fused, sequential within 1e-6 (its own
    unmasked update, ROADMAP C2), and the robust reduce moves the model
    away from the ``weighted_mean`` run under the same attack."""
    runs = {e: _port_run(algo, e, reducer)[0] for e in ENGINES}
    fused = runs["fused"]
    assert _bit_equal(runs["batched"].final_model, fused.final_model)
    assert _max_diff(runs["sequential"].final_model,
                     fused.final_model) <= 1e-6
    plain = _port_run(algo, "fused", "weighted_mean")[0]
    assert _max_diff(plain.final_model, fused.final_model) > 1e-3


@pytest.mark.parametrize("algo,reducer", [("fedsr", "median"),
                                          ("hieravg", "trimmed_mean")])
def test_chunked_robust_block_is_the_per_round_driver(algo, reducer):
    """A fused block of two attacked, robustly reduced rounds is one call
    and equals the per-round driver bit for bit."""
    block = _port_run(algo, "fused", reducer)[0]
    per_round = _port_run(algo, "fused", reducer, eval_every=1)[0]
    assert _bit_equal(per_round.final_model, block.final_model)
    assert (block.dispatches, per_round.dispatches) == (1, 2)


@pytest.mark.parametrize("engine", ["fused", "batched"])
@pytest.mark.parametrize("algo", ["fedavg", "fedsr"])
def test_robust_drop_run_matches_reference(monkeypatch, algo, engine):
    """The median under sign flips and ``drop_rate=0.3``: a dropped lane
    weighs 0 and leaves the statistic (the validity mask comes from the
    rescaled weights); against the reference, batched bit-equal to
    fused."""
    drop = {"drop_rate": 0.3}
    _assert_matches_reference(monkeypatch, algo, engine, "median",
                              scenario=drop)
    a = _port_run(algo, "fused", "median", scenario=drop)[0]
    b = _port_run(algo, "batched", "median", scenario=drop)[0]
    assert _bit_equal(a.final_model, b.final_model)


@pytest.mark.parametrize("algo", ["moon", "scaffold"])
def test_stateful_algorithms_with_the_median(monkeypatch, algo):
    """MOON's ``prev`` scatter and SCAFFOLD's variate step read the lanes
    before the reduce: against the reference on the fused engine, batched
    bit-equal to fused, sequential within 1e-6."""
    _assert_matches_reference(monkeypatch, algo, "fused", "median")
    fused = _port_run(algo, "fused", "median")[0]
    assert _bit_equal(_port_run(algo, "batched", "median")[0].final_model,
                      fused.final_model)
    assert _max_diff(_port_run(algo, "sequential", "median")[0].final_model,
                     fused.final_model) <= 1e-6


@pytest.mark.parametrize("store", ["host", "stream"])
def test_staged_store_with_prefetch_equals_the_device_store(store):
    """The staged stores remap only ``ids``, so a robust block under
    ``store="host"`` or ``"stream"``, ``prefetch=1`` (an eval a round: each
    round its own staged block) is bit-equal to ``store="device"``."""
    for algo in ("fedsr", "moon"):
        dev = _port_run(algo, "fused", "krum", eval_every=1)[0]
        staged = _port_run(algo, "fused", "krum", eval_every=1, store=store,
                           prefetch=1)[0]
        assert _bit_equal(staged.final_model, dev.final_model), algo
        assert [r.accuracy for r in staged.history] == [
            r.accuracy for r in dev.history]


def test_centralized_ignores_the_reducer(monkeypatch):
    """Centralized bypasses the plan IR, so a robust reducer changes
    nothing: the port's run equals its ``weighted_mean`` run bit for bit,
    and the reference's run with the same reducer within 1e-4."""
    from repro.core.executor import run_experiment as ref_run

    robust = _port_run("centralized", "fused", "krum", adversary={})[0]
    plain = _port_run("centralized", "fused", "weighted_mean",
                      adversary={})[0]
    assert _bit_equal(robust.final_model, plain.final_model)
    (rm, rfl), _ = configs(SMALL, algorithm="centralized", engine="fused",
                           reducer="krum", **RUN_FL)
    (rtr, rte), (_, pte) = _task()
    ref = ref_run(task="mnist_like", model_cfg=rm, fl=rfl, train=rtr,
                  test=rte, eval_every=2)
    assert_histories_equal(ref, robust, len(pte))
    assert_trees_close(robust.final_model, ref.final_model, atol=1e-4)
