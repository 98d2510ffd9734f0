"""The port's client stores and prefetch pipeline against the JAX
package's (``data/store.py``, the host half of ``core/state.py``,
``ResidencyMeter``, the pipelined driver of ``core/executor.py``).

* Store units, case for case with ``tests/test_store.py``: a cohort
  plane keeps fleet ids in its fleet-sized offsets table and its bytes
  and ``nbytes`` are the reference's; the device store uploads once; the
  host store stages per cohort and drops the previous arena; the stream
  store's arenas are the host store's byte for byte; ``close`` twice;
  a consumed prefetch counts its overlap and its pair bytes, a prefetch
  of a resident or staging set is skipped, a stale one falls back to a
  synchronous stage; ``ResidencyMeter`` as the reference's; the host
  state arena's stage, write-back, pack and unpack; peak device bytes
  O(cohort), not O(K). The stash rules of ``prefetch_block`` and
  ``_stage_state`` as ``tests/test_pipeline.py`` pins them.
* Whole runs against the reference at ``engine_parity.run_pipelined``'s
  settings (K=8, participation 0.5, dirichlet alpha 0.5, 3 rounds, an
  eval a round, so every block re-stages): plans, the RNG state after
  each plan, comm, ``h2d_bytes``, ``dispatches`` and
  ``peak_device_bytes`` exact, final weights within 1e-4 (ROADMAP C8).
* Inside the port, for all eight algorithms under every engine: each
  (store, prefetch) run bit-equal to ``store="device"``, ``prefetch=0``,
  its prefetch peak at most twice the serial one; Centralized under
  ``prefetch=1`` keeps the serial driver.
* Resume under the host store (MOON, SCAFFOLD; prefetch 0 and 1): bit
  for bit inside the port; across packages, one direction each way, the
  same checkpoint layout and the resumed model within 1e-4.

The reference's runs share one ``LocalTrainer`` (as ``engine_parity``'s
do), so its compiled steps stay warm across the cases.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (
    SMALL, assert_histories_equal, assert_schedules_equal,
    assert_trees_close, configs, jax_init, mnist_tasks, record_plans,
    to_numpy,
)

CPU = torch.device("cpu")
ALGORITHMS = ("fedsr", "fedavg", "fedprox", "ring", "hieravg", "moon",
              "scaffold", "centralized")
ENGINES = ("sequential", "batched", "fused")
STAGED = (("host", 0), ("host", 1), ("stream", 0), ("stream", 1))


def _clients(pkg="repro_torch", sizes=(5, 12, 8, 3)):
    import importlib

    ClientData = importlib.import_module(f"{pkg}.data.pipeline").ClientData
    return [ClientData(i, np.full((n, 4, 4, 1), i, np.float32),
                       np.full(n, i % 3, np.int64))
            for i, n in enumerate(sizes)]


def _store(name, clients=None):
    from repro_torch.data.store import make_store

    return make_store(name, clients or _clients(), CPU)


# ---------------------------------------------------------------------------
# cohort planes


def test_cohort_plane_offsets_table_keeps_fleet_ids():
    """A cohort plane holds only the visited shards; its offsets table is
    fleet-sized, unvisited ids at row 0; ``nbytes`` counts the table, as
    the reference's does."""
    from repro.data.pipeline import DeviceDataPlane as RefPlane
    from repro_torch.data.pipeline import DeviceDataPlane

    clients = _clients()                        # shard sizes 5, 12, 8, 3
    plane = DeviceDataPlane([clients[1], clients[3]], CPU,
                            client_ids=np.asarray([1, 3]), fleet_size=4)
    assert tuple(plane.images.shape) == (15, 4, 4, 1)
    assert plane.offsets.tolist() == [0, 0, 0, 12]
    assert (plane.images[:12] == 1.0).all() and (plane.images[12:] == 3.0).all()
    assert plane.labels.dtype == torch.int32
    assert plane.nbytes == 15 * 16 * 4 + 15 * 4 + 4 * 4
    ref = _clients("repro")
    assert plane.nbytes == RefPlane([ref[1], ref[3]],
                                    client_ids=np.asarray([1, 3]),
                                    fleet_size=4).nbytes


@pytest.mark.parametrize("visited", ["all", "one", "cohort", "unsorted"])
def test_cohort_arenas_are_the_reference_bytes(visited):
    """For the same visited fleet ids of one ``mnist_like`` fleet (made by
    each package from one seed), the port's cohort ``images``, ``labels``
    and ``offsets`` are the reference's ``DeviceDataPlane(client_ids=)``
    byte for byte, and so is ``nbytes``."""
    from repro.data.pipeline import DeviceDataPlane as RefPlane
    from repro.data.pipeline import make_clients as ref_make_clients
    from repro_torch.data.pipeline import DeviceDataPlane, make_clients

    (rtr, _), (ptr, _) = mnist_tasks(train_per_class=10, test_per_class=1)
    kw = dict(scheme="dirichlet", num_devices=8, alpha=0.5)
    ref = ref_make_clients(rtr, rng=np.random.default_rng(3), **kw)
    port = make_clients(ptr, rng=np.random.default_rng(3), **kw)
    ids = {"all": np.arange(8), "one": np.asarray([5]),
           "cohort": np.asarray([0, 2, 3, 7]),
           "unsorted": np.asarray([6, 1, 4])}[visited]
    want = RefPlane([ref[i] for i in ids], client_ids=ids, fleet_size=8)
    got = DeviceDataPlane([port[i] for i in ids], CPU, client_ids=ids,
                          fleet_size=8)
    for name in ("images", "labels", "offsets"):
        a = np.asarray(getattr(want, name))
        b = getattr(got, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert got.nbytes == want.nbytes


# ---------------------------------------------------------------------------
# store policies


def test_device_store_uploads_once():
    store = _store("device")
    assert store.kind == "device"
    first = store.arena_nbytes(np.asarray([0, 2]))
    assert first == store.arena(None).nbytes > 0
    assert store.arena_nbytes(np.asarray([1])) == 0
    assert store.arena(np.asarray([1])) is store.arena(None)
    assert store.last_pair_nbytes == first


def test_host_store_stages_per_cohort_and_frees():
    store = _store("host")
    assert store.kind == "host"
    a = store.arena(np.asarray([1, 3]))
    assert a.images.shape[0] == 15              # cohort samples only
    assert store.arena_nbytes(np.asarray([1, 3])) == 0
    assert store.arena(np.asarray([1, 3])) is a
    b_bytes = store.arena_nbytes(np.asarray([0]))
    b = store.arena(np.asarray([0]))
    assert b is not a and b_bytes == b.nbytes > 0
    assert b.images.shape[0] == 5
    assert store._arena is b                    # the previous one dropped
    store.close()


def test_make_store_rejects_unknown():
    from repro_torch.data.store import STORES

    assert sorted(STORES) == ["device", "host", "stream"]
    with pytest.raises(ValueError, match="unknown FLConfig.store"):
        _store("disk")


def test_stream_store_arenas_match_host_store():
    """The memmap round trip is lossless: a stream-store arena is the host
    store's byte for byte, and its ``clients`` keep only lengths."""
    clients = _clients()
    host, stream = _store("host", clients), _store("stream", clients)
    assert stream.kind == "stream"
    try:
        for visited in (np.asarray([1, 3]), np.asarray([0]), None):
            a, b = host.arena(visited), stream.arena(visited)
            for x, y in zip(a.tensors(), b.tensors()):
                assert x.dtype == y.dtype and torch.equal(x, y)
        assert [len(c) for c in stream.clients] == [len(c) for c in clients]
        assert not any(hasattr(c, "images") for c in stream.clients)
    finally:
        stream.close()
        host.close()


@pytest.mark.parametrize("staged", [True, False])
def test_stream_store_close_is_idempotent(staged):
    """``close`` twice is a no-op, on a store that staged and on one that
    never did; it removes the store's temp dir."""
    store = _store("stream")
    tmp = store._tmp.name
    if staged:
        store.prefetch(np.asarray([2]))
        store.arena(np.asarray([2]))
        store.prefetch(np.asarray([0]))         # left pending: drained
    assert os.path.isdir(tmp)
    store.close()
    store.close()
    assert not os.path.exists(tmp)
    assert store._stager._pool is None and store._stager._pending is None


def test_prefetch_consume_counts_overlap_and_pair_bytes():
    """A consumed prefetch's wall counts as staged and as overlapped, and
    ``last_pair_nbytes`` is the double-buffered pair at the hand-over."""
    store = _store("host")
    try:
        a = store.arena(np.asarray([1, 3]))     # a synchronous stage
        assert store.stage_seconds > 0.0
        assert store.overlapped_stage_seconds == 0.0
        assert store.last_pair_nbytes == a.nbytes
        store.prefetch(np.asarray([0, 2]))
        b = store.arena(np.asarray([0, 2]))     # consumes the prefetch
        assert b.images.shape[0] == 13
        assert store.overlapped_stage_seconds > 0.0
        assert store.last_pair_nbytes == a.nbytes + b.nbytes
    finally:
        store.close()


def test_prefetch_skips_resident_and_redundant():
    store = _store("host")
    try:
        store.arena(np.asarray([1, 3]))
        store.prefetch(np.asarray([1, 3]))      # already resident
        assert store._stager._pending is None
        store.prefetch(np.asarray([0]))
        pending = store._stager._pending
        store.prefetch(np.asarray([0]))         # already staging
        assert store._stager._pending is pending
    finally:
        store.close()


def test_stale_prefetch_falls_back_to_sync_stage():
    store = _store("host")
    try:
        store.arena(np.asarray([1]))
        before = store.overlapped_stage_seconds
        store.prefetch(np.asarray([0]))         # the lookahead guessed wrong
        c = store.arena(np.asarray([2, 3]))
        assert c.images.shape[0] == 11
        assert store._stager._pending is None
        assert store.overlapped_stage_seconds == before
        assert store.last_pair_nbytes == c.nbytes
    finally:
        store.close()


def test_residency_meter_matches_reference():
    """The same records give the reference's snapshot, field for field."""
    from repro.core.comm import ResidencyMeter as RefMeter
    from repro_torch.core.comm import ResidencyMeter

    meters = (RefMeter(), ResidencyMeter())
    for m in meters:
        m.record(100, 20)
        assert m.peak_bytes == 120
        m.record_transient(250)
        assert m.peak_bytes == 250 and (m.data_bytes, m.state_bytes) == (
            100, 20)
        m.record_transient(90)                  # never lowers the peak
        m.record_stage(2.0)
        m.record_stage(1.0, overlapped=True)
        m.record_dispatch(0.5)
        assert m.overlap_fraction == pytest.approx(1.0 / 3.0)
    assert meters[0].snapshot() == meters[1].snapshot()
    assert [f.name for f in dataclasses.fields(meters[0])] == \
        [f.name for f in dataclasses.fields(meters[1])]
    assert ResidencyMeter().overlap_fraction == 0.0


# ---------------------------------------------------------------------------
# the host state arena


def _layout():
    return (("b", (2,)), ("w", (3, 2)))


def test_stage_unstage_rows_round_trip():
    """The reference's round trip on the flat layout: a (V + 1, P) carry
    with a zeroed dump row, the rowmap sending the fleet dump K to V, and
    the write-back dropping the dump row and leaving other rows alone."""
    from repro.core.state import rowmap_for as ref_rowmap
    from repro_torch.core.state import (
        host_stack, rowmap_for, stage_rows, unstage_rows,
    )

    K = 5
    arena = host_stack(torch.zeros(8), K)
    assert arena.shape == (K, 8) and arena.dtype == np.float32
    arena += np.arange(K, dtype=np.float32)[:, None]
    visited = np.asarray([1, 4])
    staged = stage_rows(arena, visited, CPU)
    assert tuple(staged.shape) == (3, 8)
    assert (staged[2] == 0).all() and (staged[:2, 0] == torch.tensor(
        [1.0, 4.0])).all()
    rowmap = rowmap_for(visited, K)
    assert rowmap.tolist() == [2, 0, 2, 2, 1, 2]
    np.testing.assert_array_equal(rowmap, ref_rowmap(visited, K))
    arena = unstage_rows(arena, visited, staged + 10.0)
    assert arena[1, 0] == 11.0 and arena[4, 0] == 14.0
    assert arena[0, 0] == 0.0 and arena[2, 0] == 2.0


def test_host_arena_packs_and_unpacks_as_the_reference():
    """``pack_client_rows`` over a host (K, P) arena gives the reference's
    dict over its host arena, and ``unpack_client_rows(device=False)``
    restores the (K, P) numpy arena (no dump row) and ``seen``."""
    from repro.core.state import pack_client_rows as ref_pack
    from repro.core.state import unpack_client_rows as ref_unpack
    from repro_torch.core.state import pack_client_rows, unpack_client_rows

    K = 4
    host = np.arange(K * 8, dtype=np.float32).reshape(K, 8)
    ref_host = {"b": host[:, :2].copy(), "w": host[:, 2:].reshape(K, 3, 2)}
    seen = np.zeros(K + 1, bool)
    seen[[0, 2]] = True
    rows = pack_client_rows(host, seen, _layout())
    want = ref_pack(ref_host, seen)
    assert sorted(rows) == sorted(want) == [0, 2]
    for i in rows:
        for k in ("b", "w"):
            np.testing.assert_array_equal(rows[i][k], want[i][k])
    arena, seen2 = unpack_client_rows(rows, _layout(), K, False)
    ref_arena, ref_seen = ref_unpack(want, {k: v[0] for k, v in
                                            ref_host.items()}, K,
                                     device=False)
    assert isinstance(arena, np.ndarray) and arena.shape == (K, 8)
    np.testing.assert_array_equal(arena[[0, 2]], host[[0, 2]])
    assert (arena[[1, 3]] == 0).all()
    np.testing.assert_array_equal(arena[:, 2:].reshape(K, 3, 2),
                                  ref_arena["w"])
    np.testing.assert_array_equal(seen2, ref_seen)


# ---------------------------------------------------------------------------
# the pipeline's state stash (tests/test_pipeline.py)


def _moon_algo(store="host"):
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.fedsr_mlp import CONFIG
    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.core.local import LocalTrainer
    from repro_torch.data.pipeline import make_clients
    from repro_torch.data.synthetic import make_task

    fl = FLConfig(algorithm="moon", num_devices=8, num_edges=2,
                  participation=0.5, ring_rounds=2, local_epochs=1,
                  batch_size=8, engine="fused", store=store, prefetch=1)
    cfg = dataclasses.replace(CONFIG, **SMALL)
    train, _ = make_task("mnist_like", train_per_class=10, test_per_class=2,
                         seed=0)
    clients = make_clients(train, scheme="iid", num_devices=8,
                           rng=np.random.default_rng(0))
    algo = make_algorithm("moon", LocalTrainer(cfg, fl, CPU), clients, fl)
    width = sum(int(np.prod(shape)) for _, shape in algo.trainer.layout)
    return algo, torch.randn(width, generator=torch.Generator().manual_seed(0))


def test_stash_only_when_visited_sets_disjoint():
    from repro_torch.core.state import stage_rows

    algo, w = _moon_algo()
    state = {}
    algo.ensure_state(state, w)
    state["_host"]["prev"][:] = np.arange(8, dtype=np.float32)[:, None]
    sched = algo.plan_schedule(0, 1, np.random.default_rng(7), state)
    visited = sched.visited()
    assert 0 < len(visited) < 8
    algo.prefetch_block(sched, visited, state)      # the same set
    assert "_stash" not in state
    algo.prefetch_block(sched, None, state)         # no block running
    assert "_stash" not in state
    others = np.setdiff1d(np.arange(8), visited)
    algo.prefetch_block(sched, others, state)       # disjoint: staged now
    assert np.array_equal(state["_stash"]["visited"], visited)
    assert torch.equal(state["_stash"]["rows"]["prev"],
                       stage_rows(state["_host"]["prev"], visited, CPU))
    algo.engine.store.close()


def test_stage_state_consumes_matching_stash_and_drops_stale():
    algo, w = _moon_algo()
    state = {}
    algo.ensure_state(state, w)
    sched = algo.plan_schedule(0, 1, np.random.default_rng(7), state)
    visited = sched.visited()
    others = np.setdiff1d(np.arange(8), visited)
    algo.prefetch_block(sched, others, state)
    stashed = state["_stash"]["rows"]["prev"]
    algo._stage_state(state, visited)
    assert "_stash" not in state and state["prev"] is stashed
    assert state["_rowmap"].tolist() == [
        visited.tolist().index(i) if i in visited else len(visited)
        for i in range(9)]
    for key in ("prev", "_visited", "_rowmap"):
        state.pop(key)
    algo.prefetch_block(sched, others, state)
    algo._stage_state(state, others)                # a stale stash
    assert "_stash" not in state and state["prev"] is not stashed
    assert state["prev"].shape[0] == len(others) + 1
    algo.engine.store.close()


def test_prefetch_block_hands_data_to_the_staging_thread():
    algo, w = _moon_algo()
    state = {}
    algo.ensure_state(state, w)
    sched = algo.plan_schedule(0, 1, np.random.default_rng(7), state)
    store = algo.engine.store
    try:
        algo.prefetch_block(sched, sched.visited(), state)  # overlapping
        assert store._stager._pending is not None
        assert store._stager._pending[0] == tuple(sched.visited().tolist())
    finally:
        store.close()


# ---------------------------------------------------------------------------
# whole runs


PIPE_FL = dict(num_devices=8, num_edges=2, rounds=3, ring_rounds=2,
               local_epochs=1, batch_size=8, momentum=0.5, participation=0.5,
               partition="dirichlet", alpha=0.5, seed=3)
_RUNS = {}


def _pipe_task():
    if "task" not in _RUNS:
        _RUNS["task"] = mnist_tasks(train_per_class=10, test_per_class=2)
    return _RUNS["task"]


def _ref_trainer(rm, rfl):
    """The reference trainer every reference run of this file shares."""
    from repro.core.local import LocalTrainer

    if "ref_trainer" not in _RUNS:
        _RUNS["ref_trainer"] = LocalTrainer(rm, rfl)
    tr = _RUNS["ref_trainer"]
    tr.h2d_bytes = tr.dispatches = 0
    return tr


def _shared_ref_trainer(m, rm, rfl):
    """Make the reference's ``run_experiment`` use the shared trainer."""
    import repro.core.executor as ref_executor

    tr = _ref_trainer(rm, rfl)
    m.setattr(ref_executor, "LocalTrainer", lambda *a, **k: tr)
    return tr


def _ref_run(monkeypatch, rm, rfl, **kw):
    """The reference's ``run_experiment`` on the shared trainer, its
    planned blocks and the trainer's meters."""
    from repro.core.executor import run_experiment

    (rtr, rte), _ = _pipe_task()
    with monkeypatch.context() as m:
        tr = _shared_ref_trainer(m, rm, rfl)
        plans = record_plans(m, "repro.core.algorithms")
        res = run_experiment(task="mnist_like", model_cfg=rm, fl=rfl,
                             train=rtr, test=rte, **kw)
    return res, plans, (tr.h2d_bytes, tr.dispatches)


def _port_run(pm, pfl, init=None, **kw):
    from repro_torch.core.executor import run_experiment

    _, (ptr, pte) = _pipe_task()
    return run_experiment(task="mnist_like", model_cfg=pm, fl=pfl, train=ptr,
                          test=pte, init_params=init, device="cpu", **kw)


def _port_pipe(algorithm, engine, store, prefetch):
    """A cached port run at ``run_pipelined``'s settings, from the
    reference's initial weights."""
    key = (algorithm, engine, store, prefetch)
    if key not in _RUNS:
        (rm, _), (pm, pfl) = configs(SMALL, algorithm=algorithm,
                                     engine=engine, store=store,
                                     prefetch=prefetch, **PIPE_FL)
        if "init" not in _RUNS:
            _RUNS["init"] = jax_init(rm, PIPE_FL["seed"])
        _RUNS[key] = _port_run(pm, pfl, _RUNS["init"], eval_every=1)
    return _RUNS[key]


# (algorithm, engine, store, prefetch): the data path (fused engine) under
# both stores and both drivers for every algorithm, and the state path
# (MOON's, SCAFFOLD's staged rows) under the host-fed engines
REF_CASES = [
    ("fedsr", "fused", "host", 0), ("fedsr", "fused", "stream", 1),
    ("fedsr", "batched", "host", 1),
    ("fedavg", "fused", "stream", 0), ("fedavg", "fused", "host", 1),
    ("fedavg", "batched", "stream", 1),
    ("moon", "fused", "host", 0), ("moon", "fused", "host", 1),
    ("moon", "fused", "stream", 1), ("moon", "batched", "host", 1),
    ("moon", "batched", "stream", 0), ("moon", "sequential", "host", 0),
    ("scaffold", "fused", "stream", 0), ("scaffold", "fused", "host", 1),
    ("scaffold", "fused", "stream", 1), ("scaffold", "batched", "host", 0),
    ("scaffold", "batched", "stream", 1), ("scaffold", "sequential", "host", 1),
]


@pytest.mark.parametrize("algorithm,engine,store,prefetch", REF_CASES,
                         ids=["-".join(map(str, c)) for c in REF_CASES])
def test_staged_run_matches_reference(monkeypatch, algorithm, engine, store,
                                      prefetch):
    (rm, rfl), (pm, pfl) = configs(SMALL, algorithm=algorithm, engine=engine,
                                   store=store, prefetch=prefetch, **PIPE_FL)
    ref, ref_plans, (h2d, dispatches) = _ref_run(monkeypatch, rm, rfl,
                                                 eval_every=1)
    with monkeypatch.context() as m:
        plans = record_plans(m, "repro_torch.core.algorithms")
        port = _port_run(pm, pfl, jax_init(rm, PIPE_FL["seed"]),
                         eval_every=1)
    assert len(plans) == len(ref_plans) == 3
    for (ta, sa, ra), (tb, sb, rb) in zip(ref_plans, plans):
        assert ta == tb and ra == rb
        assert_schedules_equal(sa, sb)
    _, (_, pte) = _pipe_task()
    assert_histories_equal(ref, port, len(pte))
    assert port.h2d_bytes == h2d and port.dispatches == dispatches
    assert port.peak_device_bytes == ref.peak_device_bytes
    if engine == "fused":
        assert port.stage_seconds > 0.0
        assert (port.overlapped_stage_seconds > 0.0) == bool(prefetch)
    assert_trees_close(port.final_model, ref.final_model, atol=1e-4)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_stores_and_prefetch_are_bit_equal_inside_the_port(algorithm,
                                                           engine):
    """Every (store, prefetch) run equals the resident, serial one bit for
    bit — weights, accuracies, comm, learning rates, ``h2d_bytes`` apart
    from the staged cohorts — and the pipeline's peak residency stays
    within twice the serial driver's under the same store."""
    base = _port_pipe(algorithm, engine, "device", 0)
    peaks = {}
    for store, prefetch in STAGED + (("device", 1),):
        run = _port_pipe(algorithm, engine, store, prefetch)
        for k in base.final_model:
            assert torch.equal(run.final_model[k], base.final_model[k]), (
                store, prefetch, k)
        assert [(r.round, r.accuracy, r.comm, r.lr) for r in run.history] \
            == [(r.round, r.accuracy, r.comm, r.lr) for r in base.history]
        assert run.dispatches == base.dispatches
        peaks[store, prefetch] = run.peak_device_bytes
        if engine != "fused" or algorithm == "centralized":
            assert run.h2d_bytes == base.h2d_bytes
    for store in ("host", "stream"):
        assert peaks[store, 1] <= 2 * max(peaks[store, 0], 1)
        assert peaks[store, 0] <= max(base.peak_device_bytes, 1)
    assert peaks["host", 0] == peaks["stream", 0]
    assert peaks["device", 1] == base.peak_device_bytes


def test_centralized_keeps_the_serial_driver(monkeypatch):
    """``pipelinable = False``: under ``prefetch=1`` Centralized plans
    nothing ahead and stages nothing, and equals its ``prefetch=0`` run."""
    from repro_torch.core.algorithms import Centralized

    calls = []
    monkeypatch.setattr(Centralized, "prefetch_block",
                        lambda self, *a: calls.append(a))
    (_, _), (pm, pfl) = configs(SMALL, algorithm="centralized",
                                engine="fused", store="host", prefetch=1,
                                **PIPE_FL)
    blocks = []
    run = _port_run(pm, pfl, eval_every=1,
                    on_block=lambda t, s: blocks.append((t, s)))
    serial = _port_run(pm, dataclasses.replace(pfl, prefetch=0),
                       eval_every=1)
    assert calls == [] and blocks == [(0, None), (1, None), (2, None)]
    assert run.stage_seconds == 0.0 and run.peak_device_bytes == 0
    for k in run.final_model:
        assert torch.equal(run.final_model[k], serial.final_model[k])


def test_peak_device_bytes_scale_with_the_cohort():
    """Quadruple the fleet at a fixed cohort of 8: the device store's peak
    grows with the fleet, the host store's stays flat apart from its
    fleet-sized offsets table (``test_store.py``'s acceptance claim)."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.fedsr_mlp import CONFIG
    from repro_torch.core.executor import run_experiment
    from repro_torch.data.synthetic import make_task

    cfg = dataclasses.replace(CONFIG, **SMALL)
    peaks = {}
    for K in (96, 384):
        train, test = make_task("mnist_like", train_per_class=K // 10 + 1,
                                test_per_class=2, seed=0)
        for store in ("host", "device"):
            fl = FLConfig(algorithm="fedsr", num_devices=K, num_edges=K // 4,
                          participation=8 / K, rounds=2, ring_rounds=2,
                          local_epochs=1, batch_size=8, engine="fused",
                          store=store)
            peaks[store, K] = run_experiment(
                task="mnist_like", model_cfg=cfg, fl=fl, eval_every=2,
                train=train, test=test, device="cpu").peak_device_bytes
    assert peaks["device", 384] > 3 * peaks["device", 96]
    assert peaks["host", 384] < 2 * peaks["host", 96]
    assert peaks["host", 384] < 0.2 * peaks["device", 384]


# ---------------------------------------------------------------------------
# resume under the host store


def _resume_setup(algorithm, prefetch):
    """``test_host_store_resume_mid_schedule_is_exact``'s setting on the
    narrow MLP: K=4, 4 rounds, an eval at round 4, a checkpoint every 2."""
    from repro.data.synthetic import make_task as ref_make_task
    from repro_torch.data.synthetic import make_task

    kw = dict(algorithm=algorithm, num_devices=4, num_edges=2, rounds=4,
              partition="pathological", xi=2, ring_rounds=2, local_epochs=1,
              seed=11, engine="fused", store="host", prefetch=prefetch)
    (rm, rfl), (pm, pfl) = configs(SMALL, **kw)
    data = dict(train_per_class=12, test_per_class=4, seed=11)
    return ((rm, rfl) + ref_make_task("mnist_like", **data),
            (pm, pfl) + make_task("mnist_like", **data))


def _run(run_experiment, setup, **kw):
    cfg, fl, train, test = setup
    return run_experiment(task="mnist_like", model_cfg=cfg, fl=fl,
                          eval_every=4, train=train, test=test, **kw)


@pytest.mark.parametrize("prefetch", [0, 1])
@pytest.mark.parametrize("algorithm", ["moon", "scaffold"])
def test_host_store_resume_is_exact(tmp_path, algorithm, prefetch):
    """A run stopped at round 2 and resumed from its checkpoint (the host
    arenas packed into ``algo_state.msgpack``; under prefetch the RNG
    snapshotted between the two plans) equals the uninterrupted run bit
    for bit."""
    from repro_torch.core.executor import run_experiment

    ref, port = _resume_setup(algorithm, prefetch)
    init = jax_init(ref[0], 11)
    run = dict(device="cpu", init_params=init)
    full = _run(run_experiment, port, **run)
    ckdir = str(tmp_path / "ck")
    _run(run_experiment, port, checkpoint_dir=ckdir, checkpoint_every=2,
         stop_after=2, **run)
    resumed = _run(run_experiment, port, checkpoint_dir=ckdir, resume=True,
                   **run)
    assert resumed.history[-1].round == full.history[-1].round == 4
    assert resumed.history[-1].accuracy == full.history[-1].accuracy
    assert resumed.history[-1].comm == full.history[-1].comm
    for k in full.final_model:
        assert torch.equal(resumed.final_model[k], full.final_model[k]), k


def _state_file(ckdir):
    from repro_torch.checkpoint.io import restore
    from repro_torch.core.executor import _unpack_state

    return _unpack_state(restore(os.path.join(ckdir, "algo_state.msgpack")))


@pytest.mark.parametrize("direction,prefetch",
                         [("reference_to_port", 1), ("port_to_reference", 0)])
@pytest.mark.parametrize("algorithm", ["moon", "scaffold"])
def test_host_store_checkpoint_resumes_across_packages(monkeypatch, tmp_path,
                                                       algorithm, direction,
                                                       prefetch):
    """A host-store run stopped at round 2 by one package resumes in the
    other: both packages' round-2 checkpoints hold the same clients and
    leaves (values within 1e-4; SCAFFOLD's variates, model differences
    over ``K_i * lr``, within 1e-4 / 0.04 as in
    ``test_torch_checkpoint.py``), and the resumed model lies within 1e-4
    of the reference's uninterrupted run."""
    import jax.numpy as jnp
    from repro.core.executor import run_experiment as ref_run
    from repro_torch.core.executor import run_experiment

    ref, port = _resume_setup(algorithm, prefetch)
    init = jax_init(ref[0], 11)
    _shared_ref_trainer(monkeypatch, ref[0], ref[1])
    full = _run(ref_run, ref)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    _run(ref_run, ref, checkpoint_dir=ref_dir, checkpoint_every=2,
         stop_after=2)
    _run(run_experiment, port, device="cpu", init_params=init,
         checkpoint_dir=port_dir, checkpoint_every=2, stop_after=2)
    want, got = _state_file(ref_dir), _state_file(port_dir)
    atol = {"prev": 1e-4, "c": 1e-4 / 0.04, "ci": 1e-4 / 0.04}
    assert sorted(got) == sorted(want)
    for f in want:
        rows = {None: want[f]} if f == "c" else want[f]
        got_rows = {None: got[f]} if f == "c" else got[f]
        assert sorted(got_rows, key=str) == sorted(rows, key=str)
        for i in rows:
            assert sorted(got_rows[i]) == sorted(rows[i])
            for k in rows[i]:
                assert np.shape(got_rows[i][k]) == np.shape(rows[i][k])
            assert_trees_close(got_rows[i], rows[i], atol=atol[f])
    if direction == "reference_to_port":
        resumed = to_numpy(_run(run_experiment, port, device="cpu",
                                checkpoint_dir=ref_dir,
                                resume=True).final_model)
    else:
        resumed = to_numpy({k: jnp.asarray(v) for k, v in _run(
            ref_run, ref, checkpoint_dir=port_dir,
            resume=True).final_model.items()})
    assert_trees_close(resumed, full.final_model, atol=1e-4)
