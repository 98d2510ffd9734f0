"""The port's checkpoints against the JAX package's.

* ``checkpoint.io``: the same tree saved by either package gives the same
  file, byte for byte, and each package restores the other's file.
* The reference's ``test_resume_is_exact``, replayed on the port (CPU,
  fused engine): a run interrupted after round 2 and resumed to round 4
  equals the uninterrupted run bit for bit, with its history, comm meters
  and ``rounds_to_accuracy``/``comm_to_accuracy`` answers — for FedSR,
  FedAvg, FedProx, Ring, HierFAVG, MOON, SCAFFOLD and Centralized on a
  narrow MLP and FedSR on a narrow CNN.
* Across packages, both ways, for FedSR (MLP and CNN), HierFAVG, MOON and
  SCAFFOLD (MLP), the last two with their state:
  a run checkpointed by one package resumes in the other and matches the
  reference's uninterrupted run — eval rounds,
  comm meters and learning rates exactly, the restored history records
  exactly, every accuracy within one test sample, final weights within
  1e-4 (MLP) or the CNN's whole-run bound (``torch_parity.CNN_RUN_ATOL``).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from torch_parity import (
    CNN_RUN_ATOL, assert_trees_close, jax_init, to_numpy,
)

MODELS = {"mlp": ("fedsr_mlp", {"mlp_hidden": (32, 32)}, "mnist_like", 1e-4),
          "cnn": ("fedsr_cnn", {"cnn_channels": (8, 16, 16)}, "cifar10_like",
                  CNN_RUN_ATOL)}


def _setup(family, **fl_kw):
    """Both packages' (model config, FLConfig, train, test) for a narrow
    model of ``family``, and the run's whole-run weight tolerance. HierFAVG
    runs R=2 edge iterations a round, so that its second is seeded."""
    import importlib

    from repro.configs.base import FLConfig as RefFL
    from repro.data.synthetic import make_task as ref_make_task
    from repro_torch.configs.base import FLConfig
    from repro_torch.data.synthetic import make_task

    mod, overrides, task, atol = MODELS[family]
    kw = dict(algorithm="fedsr", engine="fused", num_devices=4, num_edges=2,
              rounds=4, partition="pathological", xi=2, ring_rounds=1,
              local_epochs=1, batch_size=8, seed=11)
    if fl_kw.get("algorithm") == "hieravg":
        kw["ring_rounds"] = 2
    kw.update(fl_kw)
    ref_cfg = importlib.import_module(f"repro.configs.{mod}").CONFIG
    cfg = importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
    data = dict(train_per_class=12, test_per_class=4, seed=11)
    return ((task, dataclasses.replace(ref_cfg, **overrides), RefFL(**kw),
             *ref_make_task(task, **data)),
            (task, dataclasses.replace(cfg, **overrides), FLConfig(**kw),
             *make_task(task, **data)), atol)


def _run(run_experiment, setup, **kw):
    task, cfg, fl, train, test = setup
    return run_experiment(task=task, model_cfg=cfg, fl=fl, eval_every=1,
                          train=train, test=test, **kw)


# ---------------------------------------------------------------------------
# the file layout


def _tree():
    rng = np.random.default_rng(0)
    return {
        "w": rng.standard_normal((3, 5)).astype(np.float32),
        "nested": {"i:7": np.arange(4, dtype=np.int64),
                   "mask": np.array([True, False, True])},
        "seq": (np.float32(2.5), [np.zeros((0, 2), np.float32),
                                  np.ones(70_000, np.float32)]),
        "scalar": np.int32(-3),
    }


def test_checkpoint_files_are_the_reference_bytes(tmp_path):
    from repro.checkpoint.io import restore as ref_restore
    from repro.checkpoint.io import save as ref_save
    from repro_torch.checkpoint.io import restore, save

    tree = _tree()
    ref_save(str(tmp_path / "ref.msgpack"), tree)
    save(str(tmp_path / "port.msgpack"), tree)
    # tensor leaves are saved as the same arrays
    save(str(tmp_path / "tensors.msgpack"),
         {**tree, "w": torch.from_numpy(tree["w"])})
    want = (tmp_path / "ref.msgpack").read_bytes()
    assert (tmp_path / "port.msgpack").read_bytes() == want
    assert (tmp_path / "tensors.msgpack").read_bytes() == want

    got = restore(str(tmp_path / "ref.msgpack"))
    back = ref_restore(str(tmp_path / "port.msgpack"))
    assert isinstance(got["seq"], tuple) and isinstance(got["seq"][1], list)
    for a, b, c in ((tree["w"], got["w"], back["w"]),
                    (tree["nested"]["mask"], got["nested"]["mask"],
                     back["nested"]["mask"]),
                    (tree["seq"][1][1], got["seq"][1][1], back["seq"][1][1]),
                    (tree["scalar"], got["scalar"], back["scalar"])):
        assert isinstance(b, np.ndarray) and b.dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(np.asarray(c), a)


# ---------------------------------------------------------------------------
# exact resume inside the port


@pytest.mark.parametrize("family,algorithm", [
    ("mlp", "fedsr"), ("mlp", "fedavg"), ("mlp", "ring"), ("cnn", "fedsr"),
    ("mlp", "fedprox"), ("mlp", "hieravg"), ("mlp", "moon"),
    ("mlp", "scaffold"), ("mlp", "centralized")])
def test_resume_is_exact(tmp_path, family, algorithm):
    from repro_torch.core.executor import run_experiment

    _, port, _ = _setup(family, algorithm=algorithm)
    full = _run(run_experiment, port, device="cpu")
    ckdir = str(tmp_path / "ck")
    _run(run_experiment, port, device="cpu", checkpoint_dir=ckdir,
         checkpoint_every=2, stop_after=2)
    assert sorted(os.listdir(ckdir)) == ["algo_state.msgpack",
                                         "model.msgpack", "state.json"]
    resumed = _run(run_experiment, port, device="cpu", checkpoint_dir=ckdir,
                   resume=True)

    assert [r.round for r in resumed.history] == [1, 2, 3, 4]
    for a, b in zip(full.history, resumed.history):
        assert b.accuracy == a.accuracy
        assert b.comm == a.comm
        assert b.lr == a.lr
    for k in full.final_model:
        assert torch.equal(resumed.final_model[k], full.final_model[k]), k
    target = full.history[0].accuracy
    assert resumed.rounds_to_accuracy(target) == full.rounds_to_accuracy(
        target)
    assert resumed.comm_to_accuracy(target) == full.comm_to_accuracy(target)
    with open(os.path.join(ckdir, "state.json")) as f:
        assert json.load(f)["round"] == 2


def test_resume_without_checkpoint_starts_fresh(tmp_path):
    from repro_torch.core.executor import run_experiment

    _, port, _ = _setup("mlp", rounds=1)
    res = _run(run_experiment, port, device="cpu",
               checkpoint_dir=str(tmp_path), resume=True)
    assert [r.round for r in res.history] == [1]


# ---------------------------------------------------------------------------
# across packages


@pytest.mark.parametrize("family,algorithm", [
    ("cnn", "fedsr"), ("mlp", "fedsr"), ("mlp", "hieravg")])
@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_checkpoint_resumes_across_packages(tmp_path, family, direction,
                                            algorithm):
    from repro.core.executor import run_experiment as ref_run
    from repro_torch.core.executor import run_experiment

    ref, port, atol = _setup(family, algorithm=algorithm)
    full = _run(ref_run, ref)
    ckdir = str(tmp_path / "ck")
    if direction == "reference_to_port":
        first = _run(ref_run, ref, checkpoint_dir=ckdir, checkpoint_every=2,
                     stop_after=2)
        resumed = _run(run_experiment, port, device="cpu",
                       checkpoint_dir=ckdir, resume=True)
    else:
        first = _run(run_experiment, port, device="cpu",
                     init_params=jax_init(ref[1], seed=11),
                     checkpoint_dir=ckdir, checkpoint_every=2, stop_after=2)
        resumed = _run(ref_run, ref, checkpoint_dir=ckdir, resume=True)

    test = ref[4]
    assert [r.round for r in resumed.history] == [1, 2, 3, 4]
    # the two records before the checkpoint ride along as they were saved
    for a, b in zip(first.history, resumed.history[:2]):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for a, b in zip(full.history, resumed.history):
        assert b.comm == a.comm
        assert np.float32(b.lr) == np.float32(a.lr)
        assert abs(a.accuracy - b.accuracy) <= 1.0 / len(test) + 1e-6
    final = (resumed.final_model if direction == "reference_to_port"
             else {k: jnp.asarray(v) for k, v in resumed.final_model.items()})
    assert_trees_close(to_numpy(final), full.final_model, atol=atol)


def _state_file(ckdir):
    from repro_torch.checkpoint.io import restore
    from repro_torch.core.executor import _unpack_state

    return _unpack_state(restore(os.path.join(ckdir, "algo_state.msgpack")))


# the round-4 state of a run resumed in the other package against the
# reference's uninterrupted run: MOON's previous local models are models,
# held as the final weights are; SCAFFOLD's variates divide a model's
# difference by K_i * lr (4 steps x 0.01 here), so they are held 1/0.04
# times looser (measured on a CPU: 6.0e-8 for MOON's rows, 1.7e-5 for
# SCAFFOLD's)
STATE_ATOL = {"prev": 1e-4, "c": 1e-4 / 0.04, "ci": 1e-4 / 0.04}


@pytest.mark.parametrize("algorithm", ["moon", "scaffold"])
@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_state_checkpoint_resumes_across_packages(tmp_path, direction,
                                                  algorithm):
    """MOON and SCAFFOLD: a run checkpointed after round 2 by one package
    resumes in the other (its ``algo_state.msgpack`` holds MOON's previous
    local models, or SCAFFOLD's server and client variates, by client id)
    and matches the reference's uninterrupted run: eval rounds, comm and
    learning rates exactly, accuracies within one test sample (ROADMAP
    C6: never ``rounds`` or ``seconds``), final weights within 1e-4; the
    round-4 checkpoints hold the same clients and leaves, their values
    within ``STATE_ATOL``."""
    from repro.core.executor import run_experiment as ref_run
    from repro_torch.core.executor import run_experiment

    ref, port, atol = _setup("mlp", algorithm=algorithm)
    full_dir, ckdir = str(tmp_path / "full"), str(tmp_path / "ck")
    full = _run(ref_run, ref, checkpoint_dir=full_dir, checkpoint_every=2)
    if direction == "reference_to_port":
        _run(ref_run, ref, checkpoint_dir=ckdir, checkpoint_every=2,
             stop_after=2)
        resumed = _run(run_experiment, port, device="cpu",
                       checkpoint_dir=ckdir, checkpoint_every=2, resume=True)
    else:
        _run(run_experiment, port, device="cpu",
             init_params=jax_init(ref[1], seed=11), checkpoint_dir=ckdir,
             checkpoint_every=2, stop_after=2)
        resumed = _run(ref_run, ref, checkpoint_dir=ckdir,
                       checkpoint_every=2, resume=True)

    test = ref[4]
    assert [r.round for r in resumed.history] == [1, 2, 3, 4]
    for a, b in zip(full.history, resumed.history):
        assert b.comm == a.comm
        assert np.float32(b.lr) == np.float32(a.lr)
        assert abs(a.accuracy - b.accuracy) <= 1.0 / len(test) + 1e-6
    final = (resumed.final_model if direction == "reference_to_port"
             else {k: jnp.asarray(v) for k, v in resumed.final_model.items()})
    assert_trees_close(to_numpy(final), full.final_model, atol=atol)

    want, got = _state_file(full_dir), _state_file(ckdir)
    fields = {"moon": ["prev"], "scaffold": ["c", "ci"]}[algorithm]
    assert sorted(got) == sorted(want) == fields
    for f in fields:
        rows = {None: want[f]} if f == "c" else want[f]
        got_rows = {None: got[f]} if f == "c" else got[f]
        assert sorted(got_rows, key=str) == sorted(rows, key=str)
        if f != "c":
            assert sorted(rows) == [0, 1, 2, 3]    # K=4, every client seen
        for i in rows:
            assert sorted(got_rows[i]) == sorted(rows[i])
            assert_trees_close(got_rows[i], rows[i], atol=STATE_ATOL[f])
