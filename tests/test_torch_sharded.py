"""The port's sim mesh (``launch/mesh.py``), ``engine="sharded"`` and
``FLConfig.mesh_data_axis`` against the JAX package's.

* Mesh helpers: ``round_up_to_mesh`` as the reference's for 1 to 12
  devices; ``make_sim_mesh`` capped at the fleet size; a mesh over two
  distinct devices raises ``NotImplementedError`` naming ROADMAP A5.2,
  from the mesh, the engine and the trainer; an indivisible lane axis
  raises the reference's ``ValueError`` word for word from each entry
  point that takes a mesh.
* The mesh-padded data plane: images, labels, offsets, ``nbytes`` and
  ``real_nbytes`` the reference's byte for byte on a 1-device mesh (in
  process; fleet and cohort planes, gathered into pinned buffers or not)
  and on the reference's 8-device mesh (the subprocess below);
  ``client_weights`` as the reference's.
* Ghost lanes: a padded call's ghost rows come back as their seeds, its
  real rows as the unpadded call's.
* The matrix at mesh size 1, in process: ``engine_parity.CASES`` and
  Centralized under ``engine="sharded"`` and under ``engine="fused",
  mesh_data_axis="data"``, each against the reference's run (plans, the
  RNG state after each plan, comm, ``h2d_bytes``, ``dispatches``,
  ``peak_device_bytes`` exact, the fused block one dispatch; final
  weights within 1e-4) and bit-equal to the port's run without the mesh.
  The host and stream stores, with and without prefetch, bit-equal to the
  device store under the mesh, at mesh sizes 1 and 8.
* The matrix at mesh size 8: the reference runs the same cases, plus
  ``drop30``, the median reducer under a sign-flip attack, clip-only
  DP-SGD, MOON on the host store with prefetch and a head-mode
  personalization stage (Krum is left out: ROADMAP C1), in a subprocess
  on 8 faked host devices (``torch_parity.py``'s ``mesh8`` entry point,
  started when this module's tests begin); the port runs them in process
  with ``visible_devices`` patched to eight CPU entries, held to the same
  parity target, and within 1e-6 of its own unpadded runs.
* A run checkpointed by the reference under ``mesh_data_axis`` resumes in
  the port; inside the port, resume under an 8-entry mesh is exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (
    SMALL, MESH8_PLANE_SIZES, MESH_FL, MESH_MODES, MESH_TASK,
    assert_summaries_equal, assert_trees_close, configs, finish_mesh8_reference,
    jax_init, mesh8_cases, mesh8_plane_clients, mesh_cases, mesh_configs,
    plane_summary, record_plans, reference_mesh_run, run_summary,
    start_mesh8_reference, to_numpy,
)

CPU = torch.device("cpu")
_RUNS = {}


@pytest.fixture(scope="module", autouse=True)
def mesh8_reference(tmp_path_factory):
    """The reference's 8-entry matrix, started in a subprocess as soon as
    this module's tests begin, so it runs while the in-process ones do."""
    out = str(tmp_path_factory.mktemp("mesh8"))
    proc = start_mesh8_reference(out)
    _RUNS["mesh8_proc"] = (proc, out)
    yield
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _mesh8():
    """``(meters, weights)`` of the reference's 8-entry matrix."""
    if "mesh8" not in _RUNS:
        _RUNS["mesh8"] = finish_mesh8_reference(*_RUNS["mesh8_proc"])
    return _RUNS["mesh8"]


def _sim(monkeypatch, n: int) -> None:
    """Make the sim mesh ``n`` entries of the CPU."""
    import repro_torch.launch.mesh as mesh

    monkeypatch.setattr(mesh, "visible_devices",
                        lambda device=None: [CPU] * n)


class FakeAxisMesh:
    # the reference's test lookalike: a mesh.shape with a 4-entry axis,
    # named as the port's mesh names its one axis
    def __init__(self, axis: str = "data"):
        self.axis = axis
        self.shape = {axis: 4}


# ---------------------------------------------------------------------------
# mesh helpers


@pytest.mark.parametrize("n", range(1, 13))
def test_mesh_helpers_match_reference(n):
    from repro.launch.mesh import round_up_to_mesh as ref_round
    from repro_torch.launch.mesh import SimMesh, round_up_to_mesh

    for size in (1, 2, 3, 4, 8):
        fake = type("M", (), {"shape": {"clients": size}})()
        mesh = SimMesh((CPU,) * size, "clients")
        assert round_up_to_mesh(n, mesh) == ref_round(n, fake, "clients")
        assert round_up_to_mesh(n, mesh) % size == 0


def test_make_sim_mesh_caps_at_fleet_size(monkeypatch):
    from repro_torch.launch.mesh import make_sim_mesh

    one = make_sim_mesh(64, axis="clients", device="cpu")
    assert one.axis == "clients" and one.shape == {"clients": 1}
    assert one.devices == (CPU,)
    _sim(monkeypatch, 8)
    assert make_sim_mesh(64, axis="clients").shape == {"clients": 8}
    assert make_sim_mesh().shape["data"] == 8
    assert make_sim_mesh(5).shape["data"] == 5
    assert make_sim_mesh(1).shape["data"] == 1
    assert make_sim_mesh(0).shape["data"] == 1


def test_distinct_devices_raise_a5_2(monkeypatch):
    """Two distinct cards make a mesh that would split the lane axis: the
    mesh, the engines and the trainer refuse it, naming A5.2. Capped at
    one client, the mesh is the first card alone."""
    import repro_torch.launch.mesh as mesh
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.fedsr_mlp import CONFIG
    from repro_torch.core.engines import make_engine
    from repro_torch.core.local import LocalTrainer

    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(mesh, "visible_devices", lambda device=None: cards)
    with pytest.raises(NotImplementedError, match="A5.2"):
        mesh.make_sim_mesh(8)
    assert mesh.make_sim_mesh(1).devices == (cards[0],)
    cfg = dataclasses.replace(CONFIG, **SMALL)
    for kw in ({"engine": "sharded"},
               {"engine": "fused", "mesh_data_axis": "data"},
               {"engine": "batched", "mesh_data_axis": "data"}):
        fl = FLConfig(num_devices=8, num_edges=2, **kw)
        with pytest.raises(NotImplementedError, match="A5.2"):
            make_engine(LocalTrainer(cfg, fl, CPU), [], fl)
    # a mesh of another device than the trainer's
    tr = LocalTrainer(cfg, FLConfig(), CPU)
    batches = {"images": np.zeros((2, 1, 3, 28, 28, 1), np.float32),
               "labels": np.zeros((2, 1, 3), np.int32)}
    with pytest.raises(NotImplementedError, match="A5.2"):
        tr.train_many(torch.zeros(tr_params(tr)), batches,
                      np.ones((2, 1), bool), lr=0.1, broadcast=True,
                      mesh=mesh.SimMesh((cards[0],) * 2))


def tr_params(tr) -> int:
    return sum(int(np.prod(shape)) for _, shape in tr.layout)


def _ref_message(call) -> str:
    with pytest.raises(ValueError) as err:
        call()
    return str(err.value)


@pytest.mark.parametrize("axis", ["data", "clients"])
@pytest.mark.parametrize("entry", ["train_many", "train_schedule"])
def test_indivisible_lane_axis_raises_reference_message(entry, axis):
    """C=3 lanes on a 4-entry mesh axis: the reference's ``ValueError``,
    word for word, from each entry point that takes a mesh, naming the
    axis the port reads from the mesh."""
    from repro.core.local import LocalTrainer as RefTrainer
    from repro_torch.core.local import LocalTrainer

    (rm, rfl), (pm, pfl) = configs(SMALL, batch_size=2)
    ref, port = RefTrainer(rm, rfl), LocalTrainer(pm, pfl, CPU)
    w = torch.zeros(tr_params(port))
    C, S, B = 3, 2, 2
    valid = np.ones((C, S), bool)
    mesh = FakeAxisMesh(axis)
    if entry == "train_many":
        batches = {"images": np.zeros((C, S, B, 28, 28, 1), np.float32),
                   "labels": np.zeros((C, S, B), np.int32)}
        want = _ref_message(lambda: ref.train_many(
            jax_init(rm), batches, valid, lr=0.1, broadcast=True,
            mesh=mesh, data_axis=axis))
        call = lambda: port.train_many(  # noqa: E731
            w, batches, valid, lr=0.1, broadcast=True, mesh=mesh)
    else:
        xs = {"rows": np.zeros((1, 1, C), np.int32),
              "plans": np.zeros((1, 1, C, S, B), np.int32),
              "valid": np.ones((1, 1, C, S), bool),
              "lr": np.full(1, 0.1, np.float32),
              "aggv": np.full((1, C), 1 / C, np.float32)}
        want = _ref_message(lambda: ref.train_schedule(
            jax_init(rm), None, xs, {}, mesh=mesh, data_axis=axis))
        call = lambda: port.train_schedule(  # noqa: E731
            w, None, xs, {}, mesh=mesh)
    assert f"multiple of mesh axis {axis!r}=4" in want
    with pytest.raises(ValueError) as err:
        call()
    assert str(err.value) == want


def test_engines_registered_as_the_reference(monkeypatch):
    """``sharded`` is the batched engine on the mesh; ``mesh_data_axis``
    gives the batched and fused engines the mesh, the sequential engine
    none (as the reference); an unknown engine raises the reference's
    ``ValueError``."""
    from repro.configs.base import FLConfig as RefFL
    from repro.core.engines import make_engine as ref_make
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.fedsr_mlp import CONFIG
    from repro_torch.core.engines import ENGINES, make_engine
    from repro_torch.core.engines.batched import BatchedEngine
    from repro_torch.core.local import LocalTrainer

    assert sorted(ENGINES) == ["batched", "fused", "sequential", "sharded"]
    assert ENGINES["sharded"] is BatchedEngine
    want = _ref_message(lambda: ref_make(None, [], RefFL(engine="vmap")))
    with pytest.raises(ValueError) as err:
        make_engine(None, [], FLConfig(engine="vmap"))
    assert str(err.value) == want
    _sim(monkeypatch, 8)
    cfg = dataclasses.replace(CONFIG, **SMALL)
    for kw, size in (({"engine": "sharded"}, 8),
                     ({"engine": "batched", "mesh_data_axis": "clients"}, 8),
                     ({"engine": "sequential", "mesh_data_axis": "data"},
                      None),
                     ({"engine": "batched"}, None)):
        fl = FLConfig(num_devices=8, num_edges=2, **kw)
        eng = make_engine(LocalTrainer(cfg, fl, CPU), [], fl)
        axis = fl.mesh_data_axis or "data"
        assert eng.data_axis == axis
        assert (eng.mesh and eng.mesh.shape[axis]) == size, kw
        if kw["engine"] != "sequential":
            assert eng._pad(5) == (5 if size is None else 8)


def test_mesh_module_imports_no_jax():
    """The port's mesh is its own copy: importing it, the engines and the
    stores leaves ``jax`` and ``repro`` out of ``sys.modules``."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "import repro_torch, repro_torch.launch.mesh\n"
            "import repro_torch.core.engines, repro_torch.data.store\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# the mesh-padded data plane


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("cohort", [False, True])
def test_mesh_plane_is_the_reference_bytes(monkeypatch, cohort, pinned):
    """On a 1-device mesh the padded fleet or cohort plane is the
    reference's byte for byte, ``nbytes`` and ``real_nbytes`` too; without
    a mesh ``real_nbytes`` is ``nbytes``. The CPU has no page-locked
    allocator, so the pinned case gathers through the pinned path's
    buffers allocated pageable."""
    import repro_torch.data.pipeline as pipeline
    from repro.data.pipeline import DeviceDataPlane as RefPlane
    from repro.launch.mesh import make_sim_mesh as ref_mesh
    from repro_torch.data.pipeline import DeviceDataPlane
    from repro_torch.launch.mesh import make_sim_mesh

    asked = []
    orig = pipeline._host_buffer

    def host_buffer(shape, dtype, pin):
        asked.append(pin)
        return orig(shape, dtype, False)

    monkeypatch.setattr(pipeline, "_host_buffer", host_buffer)
    ref, port = mesh8_plane_clients("repro"), mesh8_plane_clients(
        "repro_torch")
    kw = {}
    if cohort:
        ids = np.asarray([4, 1, 3])
        ref, port = [ref[i] for i in ids], [port[i] for i in ids]
        kw = dict(client_ids=ids, fleet_size=len(MESH8_PLANE_SIZES))
    want = plane_summary(RefPlane(ref, mesh=ref_mesh(), **kw))
    got = DeviceDataPlane(port, CPU, mesh=make_sim_mesh(device="cpu"),
                          pinned=pinned, **kw)
    assert plane_summary(got) == want
    assert set(asked) == {pinned}
    n_max = max(len(c) for c in port)
    assert got.images.shape[0] == len(port) * n_max
    assert got.nbytes > got.real_nbytes
    flat = DeviceDataPlane(port, CPU, pinned=pinned, **kw)
    assert flat.real_nbytes == flat.nbytes == got.real_nbytes
    assert flat.nbytes == RefPlane(ref, **kw).nbytes


def test_client_weights_match_reference():
    from repro.data.pipeline import client_weights as ref_weights
    from repro_torch.data.pipeline import client_weights

    got = client_weights(mesh8_plane_clients("repro_torch"))
    want = ref_weights(mesh8_plane_clients("repro"))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert abs(got.sum() - 1.0) < 1e-12


# ---------------------------------------------------------------------------
# ghost lanes


@pytest.mark.parametrize("use_fused_sgd", [False, True])
def test_ghost_lanes_return_their_seeds(use_fused_sgd):
    """A cohort of 5 padded to 8 lanes: the three ghost lanes' rows come
    back as their seed bit for bit, the real lanes as the unpadded call's,
    and the weight-0 reduce within 1e-6 of the unpadded one."""
    from repro_torch.core.local import LocalTrainer
    from repro_torch.data.pipeline import (
        make_clients, plan_epoch_indices, stack_plans,
    )
    from repro_torch.data.synthetic import make_task
    from repro_torch.launch.mesh import SimMesh
    from repro_torch.models.small import params_from_numpy
    from repro_torch.utils.tree import ravel_params

    (rm, _), (pm, pfl) = configs(SMALL, batch_size=8,
                                 use_fused_sgd=use_fused_sgd)
    train, _ = make_task("mnist_like", **MESH_TASK)
    clients = make_clients(train, scheme="dirichlet", num_devices=5,
                           rng=np.random.default_rng(0), alpha=0.5)
    rng = np.random.default_rng(1)
    plans = [plan_epoch_indices(c, 8, 1, rng) for c in clients]
    w = ravel_params(params_from_numpy(jax_init(rm), CPU))
    tr = LocalTrainer(pm, pfl, CPU)
    agg = np.full(8, 0.0, np.float32)
    agg[:5] = 0.2
    b5, v5 = stack_plans(clients, plans)
    b8, v8 = stack_plans(clients, plans, pad_to=8)
    lanes5 = tr.train_many(w, b5, v5, lr=0.05, broadcast=True)
    out8, lanes8 = tr.train_many(w, b8, v8, lr=0.05, broadcast=True,
                                 agg=agg, keep_locals=True,
                                 mesh=SimMesh((CPU,) * 8))
    assert torch.equal(lanes8[5:], w.expand(3, -1))
    assert torch.equal(lanes8[:5], lanes5)
    out5 = torch.from_numpy(agg[:5]) @ lanes5
    assert float((out8 - out5).abs().max()) <= 1e-6


# ---------------------------------------------------------------------------
# whole runs


def _tasks():
    if "tasks" not in _RUNS:
        from repro.data.synthetic import make_task as ref_make_task
        from repro_torch.data.synthetic import make_task

        _RUNS["tasks"] = (ref_make_task("mnist_like", **MESH_TASK),
                          make_task("mnist_like", **MESH_TASK))
    return _RUNS["tasks"]


def _init():
    if "init" not in _RUNS:
        (rm, _), _ = configs(SMALL)
        _RUNS["init"] = jax_init(rm, MESH_FL["seed"])
    return _RUNS["init"]


def _port_case(monkeypatch, algorithm, mode, ov, eval_every, mesh_size,
               meshed=True):
    """The port's ``run_experiment`` of one matrix run on a sim mesh of
    ``mesh_size`` CPU entries (``meshed=False``: the same run without the
    mesh), from the reference's initial weights: ``(result, summary)``,
    cached."""
    from repro_torch.core.executor import run_experiment

    key = ("port", algorithm, mode, repr(ov), mesh_size, meshed)
    if key not in _RUNS:
        _, (pm, pfl) = mesh_configs(algorithm, mode, ov, meshed)
        _, (train, test) = _tasks()
        with monkeypatch.context() as m:
            _sim(m, mesh_size)
            blocks = record_plans(m, "repro_torch.core.algorithms")
            res = run_experiment(
                task="mnist_like", model_cfg=pm, fl=pfl, train=train,
                test=test, init_params=_init(), eval_every=eval_every,
                device="cpu")
        _RUNS[key] = (res, run_summary(res, blocks, res.h2d_bytes,
                                       res.dispatches))
    return _RUNS[key]


def _ref_mesh1(algorithm, mode, ov, eval_every):
    (rtrain, rtest), _ = _tasks()
    (rm, rfl), _ = mesh_configs(algorithm, mode, ov)
    return reference_mesh_run(_RUNS.setdefault("ref_trainers", {}), rm, rfl,
                              rtrain, rtest, eval_every)


def _assert_bit_equal(a, b, what) -> None:
    for k in a.final_model:
        assert torch.equal(a.final_model[k], b.final_model[k]), (what, k)
    assert [(r.round, r.accuracy, r.comm) for r in a.history] == \
        [(r.round, r.accuracy, r.comm) for r in b.history], what


def _gap(a, b) -> float:
    a, b = to_numpy(a), to_numpy(b)
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


MESH1 = [(n, a, m, ov, ev) for n, a, ov, ev in mesh_cases()
         for m in MESH_MODES]


@pytest.mark.parametrize("name,algorithm,mode,ov,eval_every", MESH1,
                         ids=[f"{c[0]}-{c[2]}" for c in MESH1])
def test_mesh1_matches_reference(monkeypatch, name, algorithm, mode, ov,
                                 eval_every):
    """At mesh size 1, in process: the reference's run exactly (plans, RNG,
    comm, meters; the padded plane's ``peak_device_bytes``), its weights
    within 1e-4, the fused block one dispatch; and bit-equal to the
    port's run without the mesh (the fused engine's shapes and steps are
    those of the unmeshed run; only the plane's offsets differ)."""
    ref, want = _ref_mesh1(algorithm, mode, ov, eval_every)
    port, got = _port_case(monkeypatch, algorithm, mode, ov, eval_every, 1)
    _, (_, test) = _tasks()
    assert_summaries_equal(want, got, len(test))
    assert_trees_close(port.final_model, ref.final_model, atol=1e-4)
    plain, plain_sum = _port_case(monkeypatch, algorithm, mode, ov,
                                  eval_every, 1, meshed=False)
    _assert_bit_equal(port, plain, name)
    assert got["dispatches"] == plain_sum["dispatches"]
    if mode == "fused_mesh" and algorithm != "centralized":
        assert got["dispatches"] == 1           # the block, one call
    if mode == "sharded" or algorithm == "centralized":
        # the host-fed engine's meters do not see the mesh at size 1
        assert (got["h2d"], got["peak"]) == (plain_sum["h2d"],
                                             plain_sum["peak"])


@pytest.mark.parametrize("plane", ["fleet", "cohort"])
def test_mesh8_plane_is_the_reference_bytes(monkeypatch, plane):
    """On the reference's 8-device mesh (the subprocess), 5 shards round up
    to 8 rows of ``N_max``: the port's plane on an 8-entry sim mesh is
    the same bytes."""
    from repro_torch.data.pipeline import DeviceDataPlane
    from repro_torch.launch.mesh import make_sim_mesh

    meters, _ = _mesh8()
    assert meters["ndev"] == 8
    _sim(monkeypatch, 8)
    clients = mesh8_plane_clients("repro_torch")
    mesh = make_sim_mesh()
    if plane == "fleet":
        got = DeviceDataPlane(clients, CPU, mesh=mesh)
    else:
        ids = np.asarray([4, 1, 3])
        got = DeviceDataPlane([clients[i] for i in ids], CPU, mesh=mesh,
                              client_ids=ids, fleet_size=len(clients))
    assert plane_summary(got) == meters["planes"][plane]
    assert got.images.shape[0] == 8 * max(
        len(clients[i]) for i in ([4, 1, 3] if plane == "cohort"
                                  else range(len(clients))))


@pytest.mark.parametrize("name,algorithm,mode,ov,eval_every", mesh8_cases(),
                         ids=[f"{c[0]}-{c[2]}" for c in mesh8_cases()])
def test_mesh8_matches_reference(monkeypatch, name, algorithm, mode, ov,
                                 eval_every):
    """At mesh size 8 (the reference on 8 faked host devices, the port on
    eight CPU entries): the reference's plans, RNG, comm and meters
    exactly, its weights (and personalized fleet) within 1e-4; within
    1e-6 of the port's own run without the mesh."""
    meters, weights = _mesh8()
    port, got = _port_case(monkeypatch, algorithm, mode, ov, eval_every, 8)
    _, (_, test) = _tasks()
    assert_summaries_equal(meters["runs"][f"{name}-{mode}"], got, len(test))
    want = weights[f"{name}-{mode}"]
    assert_trees_close(port.final_model,
                       {k: v for k, v in want.items() if "/" not in k},
                       atol=1e-4)
    if port.personalized_fleet is not None:
        assert_trees_close(port.personalized_fleet,
                           {k[6:]: v for k, v in want.items()
                            if k.startswith("fleet/")}, atol=1e-4)
    plain, _ = _port_case(monkeypatch, algorithm, mode, ov, eval_every, 1,
                          meshed=False)
    assert _gap(port.final_model, plain.final_model) <= 1e-6, name
    if port.personalized_fleet is not None:
        assert _gap(port.personalized_fleet, plain.personalized_fleet) <= 1e-6


@pytest.mark.parametrize("mesh_size", [1, 8])
@pytest.mark.parametrize("algorithm", ["fedsr", "moon"])
def test_staged_stores_are_the_device_store_under_the_mesh(
        monkeypatch, algorithm, mesh_size):
    """Under ``mesh_data_axis`` the host and stream stores, with and
    without prefetch, are the device store bit for bit (their cohort
    arenas take the mesh layout), over 3 rounds at participation 0.5, an
    eval a round, so every block re-stages; prefetch's peak within twice
    the serial one."""
    base = dict(participation=0.5, rounds=3)
    dev, _ = _port_case(monkeypatch, algorithm, "fused_mesh", base, 1,
                        mesh_size)
    peaks = {}
    for store, prefetch in (("host", 0), ("host", 1), ("stream", 0),
                            ("stream", 1)):
        res, _ = _port_case(monkeypatch, algorithm, "fused_mesh",
                            dict(base, store=store, prefetch=prefetch), 1,
                            mesh_size)
        _assert_bit_equal(res, dev, (store, prefetch))
        assert res.dispatches == dev.dispatches == 3
        peaks[store, prefetch] = res.peak_device_bytes
    for store in ("host", "stream"):
        assert peaks[store, 1] <= 2 * peaks[store, 0]
    assert peaks["host", 0] == peaks["stream", 0]


# ---------------------------------------------------------------------------
# checkpoints


def test_mesh_checkpoint_resumes_across_packages(monkeypatch, tmp_path):
    """FedSR under ``engine="fused", mesh_data_axis="data"``: the
    reference checkpoints after round 2 of 4 and the port resumes to
    round 4, within 1e-4 of the reference's uninterrupted run; inside the
    port, the same stop and resume on an 8-entry mesh is its own
    uninterrupted run bit for bit."""
    from repro_torch.core.executor import run_experiment

    (rtrain, rtest), (train, test) = _tasks()
    (rm, rfl), (pm, pfl) = mesh_configs("fedsr", "fused_mesh", {"rounds": 4})
    full, _ = reference_mesh_run({}, rm, rfl, rtrain, rtest, 1)
    ckdir = str(tmp_path / "ref")
    from repro.core.executor import run_experiment as ref_run

    ref_run(task="mnist_like", model_cfg=rm, fl=rfl, train=rtrain,
            test=rtest, eval_every=1, checkpoint_dir=ckdir,
            checkpoint_every=2, stop_after=2)
    resumed = run_experiment(task="mnist_like", model_cfg=pm, fl=pfl,
                             train=train, test=test, eval_every=1,
                             device="cpu", checkpoint_dir=ckdir, resume=True)
    assert [r.round for r in resumed.history] == [1, 2, 3, 4]
    for a, b in zip(full.history, resumed.history):
        assert a.comm == b.comm
        assert round(a.accuracy * len(test)) == round(b.accuracy * len(test))
    assert_trees_close(to_numpy(resumed.final_model), full.final_model,
                       atol=1e-4)

    kw = dict(task="mnist_like", model_cfg=pm, fl=pfl, train=train,
              test=test, eval_every=1, device="cpu",
              init_params=jax_init(rm, MESH_FL["seed"]))
    with monkeypatch.context() as m:
        _sim(m, 8)
        whole = run_experiment(**kw)
        d = str(tmp_path / "port")
        run_experiment(**kw, checkpoint_dir=d, checkpoint_every=2,
                       stop_after=2)
        again = run_experiment(**kw, checkpoint_dir=d, resume=True)
    _assert_bit_equal(again, whole, "resume on 8 entries")
