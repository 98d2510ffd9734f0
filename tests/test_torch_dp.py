"""The port's DP-SGD (``core/local.py``'s ``dp_clip_noise_`` in every
engine, the planners' ledger, ``ExperimentResult.dp_epsilon``/``dp_delta``)
against the JAX package's.

* One transformed step against the reference's ``_make_dp`` on the same
  leaves (lane-stacked and one-lane), clip only, within 1e-6 relative,
  with the clip between the lanes' norms so both branches of the ``min``
  run.
* The noise, which torch cannot replay from ``jax.random``: on about 1e6
  elements ``(out - clip(g)) / sigma`` has |mean| < 5/sqrt(n), a std
  within 1% of 1 and a largest |correlation| between lanes below
  5/sqrt(n per lane), for the port's generator and for the reference's
  ``_make_dp`` alike; the same seed draws the same noise, another seed
  other noise, and clip-only draws nothing.
* Whole clip-only runs (``dp_noise_mult=0``) against the reference: all
  eight algorithms under each engine on the narrow MLP, ``use_fused_sgd``
  on and off, FedSR on the narrow CNN, and DP composed with drops, with
  ``label_flip`` and the median, and with ``store="host", prefetch=1``:
  plans, the RNG after each block, comm, ``h2d_bytes``, ``dispatches``,
  ``peak_device_bytes``, ``dp_epsilon`` (``inf``) and ``dp_delta`` exact,
  models within 1e-4 (CNN: ``CNN_RUN_ATOL``); each run clipped some
  lane-steps and left others. Inside the port batched bit-equal to fused,
  sequential within 1e-6 (ROADMAP C2).
* Noised runs: plans, meters and the ledger's epsilon equal to the
  reference's; bit-equal to a rerun, another ``dp_seed`` differs; every
  store and prefetch setting bit-equal to ``store="device"``,
  ``prefetch=0``.
* ROADMAP C9: a resumed DP run charges only the rounds after the resume,
  in both packages alike.

The reference's runs share one ``LocalTrainer`` per DP setting.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (  # noqa: E402
    CNN_RUN_ATOL, SMALL, assert_histories_equal, assert_schedules_equal,
    assert_trees_close, configs, jax_init, mnist_tasks, record_plans,
)

CPU = torch.device("cpu")
ALGOS = ("fedavg", "fedprox", "moon", "scaffold", "fedsr", "ring", "hieravg",
         "centralized")
ENGINES = ("fused", "batched", "sequential")
# between the narrow MLP's lane gradient norms in these runs (about 1.2 to
# 5.4), so every run clips some lane-steps and leaves others
CLIP = 2.5
NOISE = 1.1
# the whole-run setting of the scenario and robust tests (K=8, M=2, R=2,
# E=1, batch 8, momentum 0.5, dirichlet alpha 0.5), two rounds in a block
RUN_FL = dict(num_devices=8, num_edges=2, ring_rounds=2, local_epochs=1,
              batch_size=8, momentum=0.5, partition="dirichlet", alpha=0.5,
              seed=3, rounds=2, dp_clip=CLIP)

_RUNS = {}


def _task():
    if "task" not in _RUNS:
        _RUNS["task"] = mnist_tasks(train_per_class=10, test_per_class=2)
    return _RUNS["task"]


def _init():
    if "init" not in _RUNS:
        rm, _ = configs(SMALL)[0]
        _RUNS["init"] = jax_init(rm, RUN_FL["seed"])
    return _RUNS["init"]


# ---------------------------------------------------------------------------
# one step


def _leaves(seed, C, shapes, scale=1.0):
    """A dict of (C, *shape) float32 gradient leaves, made with numpy."""
    rng = np.random.default_rng(seed)
    return {f"l{i}": (scale * rng.normal(size=(C, *s))).astype(np.float32)
            for i, s in enumerate(shapes)}


def _ref_dp(leaves, clip, sigma, stacked, key=0):
    """The reference's transform on numpy leaves (one fresh key)."""
    import jax
    import jax.numpy as jnp
    from repro.core.local import _make_dp

    out = _make_dp(clip, sigma, stacked)(
        {k: jnp.asarray(v) for k, v in leaves.items()},
        jax.random.PRNGKey(key))
    return {k: np.asarray(v) for k, v in out.items()}


def _port_dp(leaves, clip, sigma, gen=None, stacked=True):
    """The port's transform on copies of numpy leaves, in sorted-leaf
    order: ``(leaves, factors)``."""
    from repro_torch.core.local import dp_clip_noise_

    keys = sorted(leaves)
    grads = tuple(torch.from_numpy(leaves[k].copy()) if stacked
                  else torch.from_numpy(leaves[k].copy()).unsqueeze(0)
                  for k in keys)
    fac = dp_clip_noise_(grads, clip, sigma, gen)
    return ({k: (g if stacked else g[0]).numpy()
             for k, g in zip(keys, grads)}, fac)


def _norms(leaves):
    return np.sqrt(sum(np.sum(v.astype(np.float64) ** 2,
                              axis=tuple(range(1, v.ndim)))
                       for v in leaves.values()))


MLP_LEAVES = [(32,), (32,), (10,), (784, 32), (32, 32), (32, 10)]
CNN_LEAVES = [(8,), (3, 3, 3, 8), (16,), (3, 3, 8, 16), (10,), (64, 10)]


@pytest.mark.parametrize("shapes", [MLP_LEAVES, CNN_LEAVES],
                         ids=["mlp", "cnn"])
def test_one_stacked_step_is_the_reference(shapes):
    """Six lanes whose norms spread about 40x; the clip at their median:
    clipped lanes land on the clip, the others are left bit for bit."""
    leaves = _leaves(0, 6, shapes)
    for c, s in enumerate((0.05, 0.3, 0.7, 1.0, 1.5, 2.0)):
        for v in leaves.values():
            v[c] *= s
    norms = _norms(leaves)
    clip = float(np.median(norms))
    got, fac = _port_dp(leaves, clip, 0.0)
    want = _ref_dp(leaves, clip, 0.0, True)
    clipped = norms > clip
    assert 0 < clipped.sum() < len(norms)
    np.testing.assert_array_equal(fac.numpy() < 1.0, clipped)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got[k][~clipped], leaves[k][~clipped])
    np.testing.assert_allclose(_norms(got)[clipped], clip, rtol=1e-6)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_one_lane_step_is_the_reference_train_transform(scale):
    """The sequential engine's one-lane step against the reference's
    unstacked transform (``train``'s), below and above the clip."""
    leaves = {k: v[0] for k, v in _leaves(1, 1, MLP_LEAVES, scale).items()}
    got, _ = _port_dp(leaves, 1.0, 0.0, stacked=False)
    want = _ref_dp(leaves, 1.0, 0.0, False)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the noise

STAT_LANES, STAT_P = 8, 125_000       # 1e6 elements, as two leaves a lane


def _noise_stats(out, clipped, sigma):
    """``(|mean|, std, largest |corr| between lanes)`` of the standardized
    noise ``(out - clipped) / sigma`` of (C, P) lanes, and the bounds
    ``(5/sqrt(n), 5/sqrt(n per lane))``."""
    z = ((out.astype(np.float64) - clipped) / sigma)
    n = z.size
    corr = np.corrcoef(z)
    off = np.abs(corr[~np.eye(len(z), dtype=bool)])
    return (abs(z.mean()), z.std(), off.max(),
            5 / np.sqrt(n), 5 / np.sqrt(z.shape[1]))


def _stat_leaves():
    half = STAT_P // 2
    return _leaves(2, STAT_LANES, [(half,), (STAT_P - half,)], scale=0.01)


def _flat(leaves):
    return np.concatenate([leaves[k] for k in sorted(leaves)], axis=1)


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_noise_is_standard_normal_per_element(pkg):
    """The standardized noise of one noised step in both packages: the
    same law within the stated bounds (torch cannot replay jax.random,
    so the two draw other numbers)."""
    leaves = _stat_leaves()
    clip, sigma = 0.5, NOISE * 0.5
    if pkg == "port":
        gen = torch.Generator().manual_seed(0)
        out, _ = _port_dp(leaves, clip, sigma, gen)
        clipped, _ = _port_dp(leaves, clip, 0.0)
    else:
        out = _ref_dp(leaves, clip, sigma, True)
        clipped = _ref_dp(leaves, clip, 0.0, True)
    mean, std, corr, mean_tol, corr_tol = _noise_stats(
        _flat(out), _flat(clipped), sigma)
    assert mean < mean_tol, (mean, mean_tol)
    assert abs(std - 1.0) < 0.01, std
    assert corr < corr_tol, (corr, corr_tol)


def test_noise_follows_the_generator_and_clip_only_draws_nothing():
    leaves = _leaves(3, 4, MLP_LEAVES)
    a, _ = _port_dp(leaves, 1.0, 0.5, torch.Generator().manual_seed(7))
    b, _ = _port_dp(leaves, 1.0, 0.5, torch.Generator().manual_seed(7))
    c, _ = _port_dp(leaves, 1.0, 0.5, torch.Generator().manual_seed(8))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert not np.array_equal(a[k], c[k])
    gen = torch.Generator().manual_seed(7)
    state = gen.get_state()
    _port_dp(leaves, 1.0, 0.0, gen)
    assert torch.equal(gen.get_state(), state)


def test_trainer_seeds_its_own_stream_and_dp_off_builds_none():
    from repro_torch.core.local import LocalTrainer

    (_, _), (pm, pfl) = configs(SMALL, dp_clip=1.0, dp_noise_mult=NOISE,
                                dp_seed=5)
    tr = LocalTrainer(pm, pfl, CPU)
    assert tr._dp == (1.0, NOISE)
    assert torch.equal(tr._dp_gen.get_state(),
                       torch.Generator().manual_seed(5).get_state())
    (_, _), (pm, pfl) = configs(SMALL)
    assert LocalTrainer(pm, pfl, CPU)._dp is None


# ---------------------------------------------------------------------------
# whole runs


def _ref_trainer(rm, rfl):
    """One reference trainer per DP setting and update form (the
    reference bakes both in at construction)."""
    from repro.core.local import LocalTrainer

    key = ("ref", rm.family, rfl.dp_clip, rfl.dp_noise_mult, rfl.dp_seed,
           rfl.use_fused_sgd)
    if key not in _RUNS:
        _RUNS[key] = LocalTrainer(rm, rfl)
    tr = _RUNS[key]
    tr.h2d_bytes = tr.dispatches = 0
    return tr


def _ref_run(monkeypatch, algo, engine, **fl_kw):
    """The reference's ``run_experiment`` at ``RUN_FL`` with overrides:
    its result, planned blocks and the trainer's meters."""
    import repro.core.executor as ref_executor

    run_kw, fl_kw = _split(fl_kw)
    run_kw.setdefault("eval_every", 2)
    (rm, rfl), _ = configs(SMALL, algorithm=algo, engine=engine,
                           **dict(RUN_FL, **fl_kw))
    (rtr, rte), _ = _task()
    with monkeypatch.context() as m:
        tr = _ref_trainer(rm, rfl)
        m.setattr(ref_executor, "LocalTrainer", lambda *a, **k: tr)
        plans = record_plans(m, "repro.core.algorithms")
        res = ref_executor.run_experiment(
            task="mnist_like", model_cfg=rm, fl=rfl, train=rtr, test=rte,
            **run_kw)
    return res, plans, (tr.h2d_bytes, tr.dispatches)


_RUN_ARGS = ("eval_every", "stop_after", "checkpoint_dir",
             "checkpoint_every", "resume")


def _split(kw):
    return ({k: v for k, v in kw.items() if k in _RUN_ARGS},
            {k: v for k, v in kw.items() if k not in _RUN_ARGS})


def _port_run(algo, engine, cache=True, **kw):
    """A port run at ``RUN_FL`` with overrides, from the reference's
    initial weights: ``(result, recorded blocks, (clipped, unclipped)
    lane-steps)``, cached by its arguments."""
    import repro_torch.core.local as local
    from repro_torch.core.executor import run_experiment

    key = (algo, engine, repr(sorted(kw.items())))
    if cache and key in _RUNS:
        return _RUNS[key]
    run_kw, fl_kw = _split(kw)
    run_kw.setdefault("eval_every", 2)
    _, (pm, pfl) = configs(SMALL, algorithm=algo, engine=engine,
                           **dict(RUN_FL, **fl_kw))
    _, (ptr, pte) = _task()
    saved, counts = local.dp_clip_noise_, [0, 0]

    def counted(grads, clip, sigma, gen):
        fac = saved(grads, clip, sigma, gen)
        counts[0] += int((fac < 1).sum())
        counts[1] += int((fac == 1).sum())
        return fac

    with pytest.MonkeyPatch.context() as m:
        m.setattr(local, "dp_clip_noise_", counted)
        plans = record_plans(m, "repro_torch.core.algorithms")
        res = run_experiment(task="mnist_like", model_cfg=pm, fl=pfl,
                             train=ptr, test=pte, init_params=_init(),
                             device="cpu", **run_kw)
    out = (res, plans, tuple(counts))
    if cache:
        _RUNS[key] = out
    return out


def _assert_matches_reference(monkeypatch, algo, engine, atol=1e-4, **kw):
    """Plans, RNG, comm, meters and the ledger exact; the model within
    ``atol``; the run clipped some lane-steps and left others."""
    ref, ref_plans, (h2d, dispatches) = _ref_run(monkeypatch, algo, engine,
                                                 **kw)
    port, plans, (clipped, unclipped) = _port_run(algo, engine, **kw)
    assert len(plans) == len(ref_plans)
    for (ta, sa, ra), (tb, sb, rb) in zip(ref_plans, plans):
        assert ta == tb and ra == rb
        assert_schedules_equal(sa, sb)
    _, (_, pte) = _task()
    assert_histories_equal(ref, port, len(pte))
    assert port.h2d_bytes == h2d and port.dispatches == dispatches
    assert port.peak_device_bytes == ref.peak_device_bytes
    assert port.dp_epsilon == ref.dp_epsilon
    assert port.dp_delta == ref.dp_delta == RUN_FL.get("dp_delta", 1e-5)
    assert clipped > 0 and unclipped > 0, (clipped, unclipped)
    assert_trees_close(port.final_model, ref.final_model, atol=atol)
    for v in port.final_model.values():
        assert torch.isfinite(v).all()
    return port, ref


REF_CASES = [(a, e) for a in ALGOS for e in ENGINES]


@pytest.mark.parametrize("algo,engine", REF_CASES,
                         ids=[f"{a}-{e}" for a, e in REF_CASES])
def test_clip_only_run_matches_reference(monkeypatch, algo, engine):
    port, _ = _assert_matches_reference(monkeypatch, algo, engine)
    assert port.dp_epsilon == float("inf")


FUSED_SGD_CASES = [("fedsr", "fused"), ("fedavg", "batched"),
                   ("moon", "fused"), ("hieravg", "fused"),
                   ("fedprox", "sequential"), ("centralized", "fused")]


@pytest.mark.parametrize("algo,engine", FUSED_SGD_CASES,
                         ids=[f"{a}-{e}" for a, e in FUSED_SGD_CASES])
def test_clip_only_run_with_fused_sgd_matches_reference(monkeypatch, algo,
                                                        engine):
    """The update through ``fused_sgd_lanes`` (its plain version on the
    CPU), which reads the transformed leaves in place."""
    _assert_matches_reference(monkeypatch, algo, engine, use_fused_sgd=True)


def _bit_equal(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def _max_diff(a, b) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


@pytest.mark.parametrize("algo", ALGOS)
def test_engines_agree_under_the_clip(algo):
    """Batched bit-equal to fused, sequential within 1e-6 (its unmasked
    update, ROADMAP C2), and the clip moves the model away from the run
    without DP by more than the reference runs' tolerance."""
    runs = {e: _port_run(algo, e)[0] for e in ENGINES}
    fused = runs["fused"].final_model
    assert _bit_equal(runs["batched"].final_model, fused)
    assert _max_diff(runs["sequential"].final_model, fused) <= 1e-6
    plain = _port_run(algo, "fused", dp_clip=0.0)[0]
    assert plain.dp_epsilon is None and plain.dp_delta is None
    assert _max_diff(plain.final_model, fused) > 1e-4


def test_clip_only_cnn_run_matches_reference():
    """FedSR on the narrow CNN (channels 8, 16, 16), four conv and two
    dense leaves through the clip, fused_sgd on."""
    import repro.core.executor as ref_executor
    from repro.configs.fedsr_cnn import CONFIG as REF
    from repro.data.synthetic import make_task as ref_make_task
    from repro_torch.configs.fedsr_cnn import CONFIG
    from repro_torch.core.executor import run_experiment
    from repro_torch.data.synthetic import make_task

    narrow = {"cnn_channels": (8, 16, 16)}
    rc, pc = (dataclasses.replace(REF, **narrow),
              dataclasses.replace(CONFIG, **narrow))
    kw = dict(algorithm="fedsr", engine="fused", num_devices=4, num_edges=2,
              ring_rounds=2, rounds=2, batch_size=8,
              partition="pathological", use_fused_sgd=True, dp_clip=CLIP)
    (_, rfl), (_, pfl) = configs(**kw)
    rtr, rte = ref_make_task("cifar10_like", train_per_class=8,
                             test_per_class=4)
    ptr, pte = make_task("cifar10_like", train_per_class=8, test_per_class=4)
    ref = ref_executor.run_experiment(task="cifar10_like", model_cfg=rc,
                                      fl=rfl, eval_every=2, train=rtr,
                                      test=rte)
    port = run_experiment(task="cifar10_like", model_cfg=pc, fl=pfl,
                          eval_every=2, train=ptr, test=pte,
                          init_params=jax_init(rc), device="cpu")
    assert [r.comm for r in ref.history] == [r.comm for r in port.history]
    assert port.dp_epsilon == ref.dp_epsilon == float("inf")
    assert_trees_close(port.final_model, ref.final_model, atol=CNN_RUN_ATOL)


@pytest.mark.parametrize("algo,engine", [("fedavg", "fused"),
                                         ("fedsr", "batched")])
def test_clip_with_drops_matches_reference(monkeypatch, algo, engine):
    """A dropped visit's lane is transformed and discarded; the ledger
    charges survivors only."""
    _assert_matches_reference(monkeypatch, algo, engine,
                              scenario={"drop_rate": 0.3})


@pytest.mark.parametrize("algo", ["fedavg", "fedsr"])
def test_clip_with_label_flip_and_the_median_matches_reference(
        monkeypatch, algo):
    _assert_matches_reference(
        monkeypatch, algo, "fused", reducer="median",
        adversary={"frac": 0.25, "kind": "label_flip"})


@pytest.mark.parametrize("algo", ["fedsr", "moon"])
def test_clip_with_the_host_store_and_prefetch_matches_reference(
        monkeypatch, algo):
    port, _ = _assert_matches_reference(monkeypatch, algo, "fused",
                                        eval_every=1, store="host",
                                        prefetch=1)
    dev = _port_run(algo, "fused", eval_every=1)[0]
    assert _bit_equal(port.final_model, dev.final_model)


# ---------------------------------------------------------------------------
# noised runs


@pytest.mark.parametrize("algo,engine", [
    ("fedsr", "fused"), ("fedavg", "batched"), ("hieravg", "fused"),
    ("scaffold", "sequential"), ("centralized", "fused")])
def test_noised_run_reports_the_reference_ledger(monkeypatch, algo, engine):
    """Noise on: the noise never touches the experiment's RNG, so plans,
    RNG, comm and meters stay exact against the reference, and so does
    the ledger's finite epsilon; the model is finite and moved by the
    noise."""
    ref, ref_plans, (h2d, dispatches) = _ref_run(
        monkeypatch, algo, engine, dp_noise_mult=NOISE)
    port, plans, _ = _port_run(algo, engine, dp_noise_mult=NOISE)
    assert len(plans) == len(ref_plans)
    for (ta, sa, ra), (tb, sb, rb) in zip(ref_plans, plans):
        assert ta == tb and ra == rb
        assert_schedules_equal(sa, sb)
    assert [r.comm for r in port.history] == [r.comm for r in ref.history]
    assert port.h2d_bytes == h2d and port.dispatches == dispatches
    assert 0 < port.dp_epsilon < float("inf")
    assert (port.dp_epsilon, port.dp_delta) == (ref.dp_epsilon, ref.dp_delta)
    for v in port.final_model.values():
        assert torch.isfinite(v).all()
    clip_only = _port_run(algo, engine)[0]
    assert _max_diff(port.final_model, clip_only.final_model) > 1e-3


def test_noised_run_is_its_rerun_and_another_seed_differs():
    a = _port_run("fedsr", "fused", dp_noise_mult=NOISE)[0]
    b = _port_run("fedsr", "fused", cache=False, dp_noise_mult=NOISE)[0]
    c = _port_run("fedsr", "fused", dp_noise_mult=NOISE, dp_seed=1)[0]
    assert _bit_equal(a.final_model, b.final_model)
    assert [r.accuracy for r in a.history] == [r.accuracy for r in b.history]
    assert _max_diff(a.final_model, c.final_model) > 1e-3
    assert a.dp_epsilon == c.dp_epsilon


STORES = [("host", 0), ("host", 1), ("stream", 0), ("stream", 1),
          ("device", 1)]


@pytest.mark.parametrize("store,prefetch", STORES,
                         ids=[f"{s}-{p}" for s, p in STORES])
@pytest.mark.parametrize("algo", ["fedsr", "moon"])
def test_noised_run_is_bit_equal_across_stores(algo, store, prefetch):
    """The generator is drawn only on the training thread, in step order,
    so neither the store nor the staging thread moves the noise: every
    setting bit-equal to ``store="device"``, ``prefetch=0`` (an eval a
    round, so each round is a staged block)."""
    dev = _port_run(algo, "fused", dp_noise_mult=NOISE, eval_every=1)[0]
    got = _port_run(algo, "fused", dp_noise_mult=NOISE, eval_every=1,
                    store=store, prefetch=prefetch)[0]
    assert _bit_equal(got.final_model, dev.final_model)
    assert [r.accuracy for r in got.history] == [
        r.accuracy for r in dev.history]
    assert got.dp_epsilon == dev.dp_epsilon


def test_ledger_charges_max_client_steps():
    """The reference's own pin (``tests/test_adversary.py``): iid
    10-sample shards, batch 8, so 2 steps a visit; R=2 laps visit each
    client twice a round; 2 rounds, so 8 steps."""
    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.core.comm import CommMeter
    from repro_torch.core.local import LocalTrainer
    from repro_torch.data.pipeline import make_clients
    from repro_torch.data.synthetic import make_task
    from repro_torch.models.small import init_small_model
    from repro_torch.utils.tree import ravel_params

    train, _ = make_task("mnist_like", train_per_class=8, test_per_class=2,
                         seed=0)
    (_, _), (pm, fl) = configs(
        SMALL, algorithm="fedsr", num_devices=8, num_edges=2, rounds=2,
        ring_rounds=2, local_epochs=1, batch_size=8, engine="fused",
        dp_clip=1.0, dp_noise_mult=NOISE)
    clients = make_clients(train, scheme="iid", num_devices=8,
                           rng=np.random.default_rng(0))
    algo = make_algorithm("fedsr", LocalTrainer(pm, fl, CPU), clients, fl)
    assert algo.privacy is not None and algo.privacy.steps == 0
    w0 = ravel_params(init_small_model(torch.Generator().manual_seed(0),
                                       pm, CPU))
    algo.run_schedule(w0, 0, np.full(2, 0.05), np.random.default_rng(7),
                      CommMeter(), {})
    assert algo.privacy.steps == 8
    assert np.isfinite(algo.privacy.epsilon())


def test_resumed_dp_run_charges_only_the_resumed_rounds(monkeypatch,
                                                       tmp_path):
    """ROADMAP C9: neither package checkpoints the ledger, so a run
    stopped after round 2 and resumed to round 4 reports the epsilon of
    rounds 3 and 4 alone, below the uninterrupted run's, and the same in
    both packages."""
    kw = dict(rounds=4, dp_noise_mult=NOISE, checkpoint_every=2)
    eps = {}
    for pkg in ("ref", "port"):
        ck = str(tmp_path / pkg)
        run = (lambda **k: _ref_run(monkeypatch, "fedsr", "fused", **k)[0]
               ) if pkg == "ref" else (
            lambda **k: _port_run("fedsr", "fused", cache=False, **k)[0])
        full = run(**kw)
        run(checkpoint_dir=ck, stop_after=2, **kw)
        resumed = run(checkpoint_dir=ck, resume=True, **kw)
        assert [r.round for r in resumed.history] == [2, 4]
        eps[pkg] = (full.dp_epsilon, resumed.dp_epsilon)
    assert eps["port"] == eps["ref"]
    full, resumed = eps["port"]
    assert 0 < resumed < full
    # the resumed rounds alone: a fresh run of two rounds charges as much
    two = _port_run("fedsr", "fused", dp_noise_mult=NOISE)[0]
    assert resumed == two.dp_epsilon
