"""MOON, SCAFFOLD and Centralized in the port, against the JAX package's.

* ``core.state``: ``scaffold_step`` within 1e-6 of the reference's (dead
  lanes on the dump row included); ``pack_client_rows`` and
  ``unpack_client_rows`` exact both ways, leaf names and client ids
  included, and the dump row never packed.
* The models' penultimate features (MOON reads them), the paper MLP and a
  narrow CNN, within 1e-5 of ``small_model_features``.
* MOON's loss and lane gradients against the reference's own
  ``moon_loss`` (MLP at full width and a narrow CNN) within 1e-5; one MOON
  and one SCAFFOLD visit (``train``, unmasked) and one masked hop
  (``train_many``, a lane stopping early) within 1e-5 of the reference's,
  each away from the plain loss's by more than 100 times that bound.
* Whole runs of MOON and SCAFFOLD through ``run_experiment`` from the
  reference's initial weights under all three engines, ``use_fused_sgd``
  on and off, at K=4 (participation 1.0) and K=8 (0.5), an eval every 2
  rounds: eval rounds, comm, learning rates, accuracies (as counts of
  test images), ``h2d_bytes``, ``dispatches`` and ``peak_device_bytes``
  equal to the reference's, the last also to literals; final weights
  within 1e-4. Inside the port batched is bit-equal to fused and
  sequential within 1e-6; SCAFFOLD never calls ``fused_sgd``.
* Centralized against the reference under every engine (it ignores the
  engine), its refusals, and what ``on_block`` receives.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from torch_parity import (
    SMALL, assert_histories_equal, assert_trees_close, configs, fl_kwargs,
    jax_init, mnist_tasks, ref_run_recorded,
)

CPU = torch.device("cpu")
ENGINES = ("sequential", "batched", "fused")
TOL = 1e-5
NARROW_CNN = {"cnn_channels": (8, 16, 16)}


def _layout(cfg):
    from repro_torch.models.small import small_model_specs

    specs = small_model_specs(cfg)
    return tuple((k, specs[k].shape) for k in sorted(specs))


def _flat(tree) -> torch.Tensor:
    return torch.cat([torch.as_tensor(np.asarray(v)).reshape(-1)
                      for _, v in sorted(tree.items())])


def _tree(flat: np.ndarray, layout, lead=()) -> dict:
    """A (..., P) numpy array as the reference's leaf dict."""
    out, off = {}, 0
    for k, shape in layout:
        n = int(np.prod(shape))
        out[k] = flat[..., off:off + n].reshape(*lead, *shape)
        off += n
    return out


# ---------------------------------------------------------------------------
# core.state


def test_scaffold_step_matches_reference():
    """Eight lanes, one of them dead (its id the dump row K, weight 0):
    the new server variate and client stack within 1e-6 of the
    reference's, rows no lane names untouched, the dump row written. The
    values have a round's scale: lanes 0.03 from the global model, divided
    by ``K_i * lr`` of about 0.03, give variates of order 1 (at order 30
    the two packages' divisions sit an ulp, ~2e-6, apart)."""
    from repro.core.state import scaffold_step as ref_step
    from repro_torch.core.state import scaffold_step

    rng = np.random.default_rng(0)
    K, C, P = 11, 8, 1000
    c = rng.standard_normal(P).astype(np.float32) * 0.1
    ci = rng.standard_normal((K + 1, P)).astype(np.float32) * 0.1
    ids = np.asarray([3, 0, 7, 10, 5, 1, K, 9], np.int32)
    w = rng.standard_normal(P).astype(np.float32)
    locals_ = (w + 0.03 * rng.standard_normal((C, P))).astype(np.float32)
    kl = np.asarray([k * 0.0099862953475457 for k in (3, 5, 4, 4, 2, 6, 1,
                                                      3)], np.float32)
    mw = np.where(ids < K, np.float32(1 / 7), np.float32(0)).astype(
        np.float32)
    frac = np.float32(7 / K)
    rc, rci = ref_step({"x": jnp.asarray(c)}, {"x": jnp.asarray(ci)},
                       jnp.asarray(ids), {"x": jnp.asarray(locals_)},
                       {"x": jnp.asarray(w)}, jnp.asarray(kl),
                       jnp.asarray(mw), frac)
    t = torch.from_numpy
    pc, pci = scaffold_step(t(c), t(ci), t(ids).long(), t(locals_), t(w),
                            t(kl), t(mw), torch.tensor(frac))
    np.testing.assert_allclose(pc.numpy(), np.asarray(rc["x"]), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(pci.numpy(), np.asarray(rci["x"]), atol=1e-6,
                               rtol=0)
    untouched = sorted(set(range(K)) - set(ids.tolist()))
    np.testing.assert_array_equal(pci.numpy()[untouched], ci[untouched])
    assert not np.array_equal(pci.numpy()[K], ci[K])
    assert float(np.abs(pc.numpy() - c).max()) > 1e-3


def _state_stack(layout, K, seed=1):
    rng = np.random.default_rng(seed)
    width = sum(int(np.prod(s)) for _, s in layout)
    stack = rng.standard_normal((K + 1, width)).astype(np.float32)
    seen = np.zeros(K + 1, bool)
    seen[[0, 3, 4, K - 1, K]] = True        # the dump row is never packed
    return stack, seen


def test_pack_client_rows_is_the_reference_layout():
    """A (K + 1, P) stack of the paper MLP's layout packs to the
    reference's ``{client_id: {leaf: array}}`` exactly: the same ids (the
    seen rows below K), leaf names, shapes, dtypes and bytes."""
    from repro.core.state import pack_client_rows as ref_pack
    from repro_torch.configs.fedsr_mlp import CONFIG
    from repro_torch.core.state import client_stack, pack_client_rows

    layout = _layout(CONFIG)
    K = 6
    stack, seen = _state_stack(layout, K)
    want = ref_pack(jax.tree.map(jnp.asarray, _tree(stack, layout, (K + 1,))),
                    seen)
    got = pack_client_rows(torch.from_numpy(stack), seen, layout)
    assert sorted(got) == sorted(want) == [0, 3, 4, K - 1]
    for i in want:
        assert sorted(got[i]) == sorted(want[i]) == [k for k, _ in layout]
        for k in want[i]:
            a, b = np.asarray(want[i][k]), got[i][k]
            assert a.dtype == b.dtype and a.shape == b.shape, (i, k)
            assert a.tobytes() == b.tobytes(), (i, k)
    zero = client_stack(torch.ones(7), K)
    assert zero.shape == (K + 1, 7) and not zero.any()
    assert pack_client_rows(zero, np.zeros(K + 1, bool), (("x", (7,)),)) \
        == {}


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_unpack_client_rows_inverts_either_package(direction):
    """Rows packed by one package unpack in the other to the same stack
    (unseen rows and the dump row zero) and the same ``seen`` mask."""
    from repro.core.state import pack_client_rows as ref_pack
    from repro.core.state import unpack_client_rows as ref_unpack
    from repro_torch.configs.fedsr_mlp import CONFIG
    from repro_torch.core.state import pack_client_rows, unpack_client_rows

    layout = _layout(CONFIG)
    K = 6
    stack, seen = _state_stack(layout, K)
    want = np.where(seen[:, None], stack, 0)
    want[K] = 0
    ref_stack = jax.tree.map(jnp.asarray, _tree(stack, layout, (K + 1,)))
    if direction == "reference_to_port":
        got, got_seen = unpack_client_rows(ref_pack(ref_stack, seen), layout,
                                           K, CPU)
        got = got.numpy()
    else:
        tree, got_seen = ref_unpack(
            pack_client_rows(torch.from_numpy(stack), seen, layout),
            _tree(stack[0], layout), K)
        got = np.concatenate([np.asarray(tree[k]).reshape(K + 1, -1)
                              for k, _ in layout], axis=1)
    assert got.dtype == np.float32 and got.shape == (K + 1, stack.shape[1])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_seen, np.r_[seen[:K], False])


# ---------------------------------------------------------------------------
# MOON's features and loss, SCAFFOLD's update


def _model(family):
    import repro.configs.fedsr_cnn as ref_cnn
    import repro.configs.fedsr_mlp as ref_mlp
    import repro_torch.configs.fedsr_cnn as port_cnn
    import repro_torch.configs.fedsr_mlp as port_mlp

    if family == "mlp":
        return ref_mlp.CONFIG, port_mlp.CONFIG
    return (dataclasses.replace(ref_cnn.CONFIG, **NARROW_CNN),
            dataclasses.replace(port_cnn.CONFIG, **NARROW_CNN))


def _images(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.random(shape + (cfg.image_size, cfg.image_size,
                               cfg.image_channels), dtype=np.float32)


@pytest.mark.parametrize("family", ["mlp", "cnn"])
def test_features_match_reference(family):
    """The penultimate ReLU features of the paper MLP (200 units) and a
    narrow CNN (64 units after the first FC layer) on 16 images."""
    from repro.models.small import small_model_features as ref_features
    from repro_torch.models.small import params_from_numpy, small_model_features

    rm, pm = _model(family)
    w = jax_init(rm, 2)
    images = _images(rm, (16,), 0)
    want = np.asarray(ref_features(jax.tree.map(jnp.asarray, w),
                                   jnp.asarray(images), rm))
    got = small_model_features(params_from_numpy(w, CPU),
                               torch.from_numpy(images), pm).numpy()
    assert got.shape == want.shape == (16, 200 if family == "mlp" else 64)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert (got > 0).any() and (got == 0).any()


@pytest.mark.parametrize("family", ["mlp", "cnn"])
def test_moon_lane_losses_and_gradients_match_reference(family):
    """Three lanes, each with its own weights and previous local model,
    one global model: the port's ``lane_grads`` with ``w_glob``/``w_prev``
    against the reference's ``moon_loss`` (vmapped over lanes, the global
    shared), losses and every leaf's gradient within 1e-5. Controls
    against a term that is dropped: the contrastive term (``mu`` = 0.01 of
    it) moves each lane's loss by more than 100 times the bound, and the
    gradient by more than 10 times (9.2e-4 for the full-width MLP's
    draws here; the visit tests hold the step itself at 100 times)."""
    from repro.core.local import LocalTrainer as RefTrainer
    from repro_torch.core.local import LocalTrainer
    from repro_torch.models.small import params_from_numpy
    from repro_torch.utils.tree import ravel_params

    (rm, pm), C, B = _model(family), 3, 16
    _, (_, pfl) = configs(SMALL)
    from repro.configs.base import FLConfig as RefFL
    rfl = RefFL()
    assert (pfl.mu, pfl.moon_tau) == (rfl.mu, rfl.moon_tau) == (0.01, 0.5)
    lanes = [jax_init(rm, s) for s in range(C)]
    prev = [jax_init(rm, 10 + s) for s in range(C)]
    glob = jax_init(rm, 20)
    images = _images(rm, (C, B), 1)
    labels = np.random.default_rng(2).integers(0, 10, (C, B)).astype(np.int32)

    moon_loss = RefTrainer(rm, rfl)._many_spec["moon"][0]

    def stack(trees):
        return {k: jnp.stack([t[k] for t in trees]) for k in trees[0]}

    ref_l, ref_g = jax.jit(jax.vmap(
        jax.value_and_grad(lambda p, x, y, g, q: moon_loss(
            p, {"images": x, "labels": y}, g, q)),
        in_axes=(0, 0, 0, None, 0)))(
        stack(lanes), jnp.asarray(images), jnp.asarray(labels),
        jax.tree.map(jnp.asarray, glob), stack(prev))

    trainer = LocalTrainer(pm, pfl, CPU)

    def flat(tree):
        return ravel_params(params_from_numpy(tree, CPU))

    params = torch.stack([flat(w) for w in lanes])
    batch = {"images": torch.from_numpy(images),
             "labels": torch.from_numpy(labels)}
    losses, grads = trainer.lane_grads(
        params, batch, w_glob=flat(glob),
        w_prev=torch.stack([flat(w) for w in prev]))
    names = [k for k, _ in trainer.layout]
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_l), atol=TOL,
                               rtol=0)
    assert_trees_close(dict(zip(names, grads)), ref_g, atol=TOL)
    plain_l, plain_g = trainer.lane_grads(params, batch)
    moved = max(float((a - b).abs().max()) for a, b in zip(grads, plain_g))
    assert moved > 10 * TOL, moved
    assert float((losses - plain_l).abs().min()) > 100 * TOL


def _visit_setup(variant, use_fused_sgd):
    """Both trainers on the narrow MLP, client 1's shard, the initial
    weights and the variant's extras in both packages' forms."""
    from repro.core.local import LocalTrainer as RefTrainer
    from repro.data.pipeline import make_clients as ref_make_clients
    from repro_torch.core.local import LocalTrainer
    from repro_torch.data.pipeline import make_clients
    from repro_torch.models.small import params_from_numpy
    from repro_torch.utils.tree import ravel_params

    (rm, rfl), (pm, pfl) = configs(SMALL, **fl_kwargs(
        use_fused_sgd=use_fused_sgd, batch_size=6))
    (rtr, _), (ptr, _) = mnist_tasks()
    rc = ref_make_clients(rtr, scheme="pathological", num_devices=4,
                          rng=np.random.default_rng(0))
    pc = make_clients(ptr, scheme="pathological", num_devices=4,
                      rng=np.random.default_rng(0))
    names = ("w_glob", "w_prev") if variant == "moon" else ("c_glob",
                                                           "c_local")
    trees = [jax_init(rm, s) for s in (3, 4, 5)]
    if variant == "scaffold":
        # variates of the size a few rounds give them
        trees[1:] = [{k: v * 0.05 for k, v in t.items()} for t in trees[1:]]

    def flat(tree):
        return ravel_params(params_from_numpy(tree, CPU))

    ref_kw = {n: jax.tree.map(jnp.asarray, t)
              for n, t in zip(names, trees[1:])}
    port_kw = {n: flat(t) for n, t in zip(names, trees[1:])}
    return (RefTrainer(rm, rfl), LocalTrainer(pm, pfl, CPU), rc, pc,
            trees[0], flat(trees[0]), ref_kw, port_kw)


@pytest.mark.parametrize("use_fused_sgd", [False, True])
@pytest.mark.parametrize("variant", ["moon", "scaffold"])
def test_one_state_visit_matches_reference(variant, use_fused_sgd):
    """``train`` (the sequential engine's unmasked update) over a
    two-epoch visit with MOON's extras or SCAFFOLD's variates: within 1e-5
    of the reference's ``train(variant=...)``, with the reference's meters,
    and away from the plain visit by more than 100 times that."""
    from repro.data.pipeline import plan_epoch_indices as ref_plan
    from repro_torch.utils.tree import unravel

    ref_tr, tr, rc, pc, w0, w, ref_kw, port_kw = _visit_setup(
        variant, use_fused_sgd)
    plan = ref_plan(rc[1], 6, 2, np.random.default_rng(1))
    want = ref_tr.train(jax.tree.map(jnp.asarray, w0), rc[1], lr=0.05,
                        plan=plan, variant=variant, **ref_kw)
    got = tr.train(w, pc[1], lr=0.05, plan=plan, variant=variant, **port_kw)
    assert_trees_close(unravel(got, tr.layout), want, atol=TOL)
    assert tr.dispatches == ref_tr.dispatches == plan.shape[0]
    assert tr.h2d_bytes == ref_tr.h2d_bytes
    plain = tr.train(w, pc[1], lr=0.05, plan=plan)
    assert float((got - plain).abs().max()) > 100 * TOL


@pytest.mark.parametrize("use_fused_sgd", [False, True])
@pytest.mark.parametrize("variant", ["moon", "scaffold"])
def test_one_state_hop_matches_reference(variant, use_fused_sgd):
    """``train_many`` (the masked update) over three clients of uneven
    plans — the short ones stop early, so later steps are masked — with
    per-lane extras (MOON's three previous models, SCAFFOLD's three client
    variates) and the reduce folded in with ``keep_locals``: the aggregate
    and the trained lanes within 1e-5 of the reference's."""
    from repro.data.pipeline import plan_epoch_indices as ref_plan
    from repro.data.pipeline import stack_plans as ref_stack
    from repro_torch.utils.tree import unravel

    ref_tr, tr, rc, pc, w0, w, ref_kw, port_kw = _visit_setup(
        variant, use_fused_sgd)
    rng = np.random.default_rng(3)
    plans = [ref_plan(rc[i], 6, e, rng) for i, e in ((0, 2), (1, 1), (3, 3))]
    batches, valid = ref_stack([rc[0], rc[1], rc[3]], plans)
    assert not valid.all()
    agg = np.asarray([0.5, 0.2, 0.3], np.float32)
    per_lane = "w_prev" if variant == "moon" else "c_local"
    lane = port_kw[per_lane]
    port_kw[per_lane] = torch.stack([lane, 0.5 * lane, -lane])
    ref_kw[per_lane] = jax.tree.map(
        lambda x: jnp.stack([x, 0.5 * x, -x]), ref_kw[per_lane])
    want_agg, want_lanes = ref_tr.train_many(
        jax.tree.map(jnp.asarray, w0), batches, valid, lr=0.05,
        variant=variant, broadcast=True, agg=agg, keep_locals=True, **ref_kw)
    got_agg, got_lanes = tr.train_many(
        w, batches, valid, lr=0.05, variant=variant, broadcast=True, agg=agg,
        keep_locals=True, **port_kw)
    assert_trees_close(unravel(got_agg, tr.layout), want_agg, atol=TOL)
    assert_trees_close(unravel(got_lanes, tr.layout), want_lanes, atol=TOL)
    plain = tr.train_many(w, batches, valid, lr=0.05, broadcast=True,
                          agg=agg)
    assert float((got_agg - plain).abs().max()) > 100 * TOL


# ---------------------------------------------------------------------------
# whole runs


def _port_run(pm, pfl, ptr, pte, init, **kw):
    from repro_torch.core.executor import run_experiment

    return run_experiment(task="mnist_like", model_cfg=pm, fl=pfl,
                          train=ptr, test=pte, init_params=init,
                          device="cpu", **kw)


def _state_fl(algorithm, engine, K, participation, use_fused_sgd):
    """The tests' small setting: the narrow MLP, batch 8, E=1, R=1, four
    rounds."""
    return configs(SMALL, **fl_kwargs(
        algorithm=algorithm, engine=engine, num_devices=K,
        participation=participation, use_fused_sgd=use_fused_sgd,
        ring_rounds=1))


# device-resident state bytes of the narrow MLP (P = 26,506): (K + 1)·P·4 a
# client stack, P·4 more for SCAFFOLD's server variate, and the fused
# engine's data plane on top (628,016 bytes for the whole fleet)
PEAK = {("moon", 4): (530_120, 1_158_136),
        ("scaffold", 4): (636_144, 1_264_160),
        ("moon", 8): (954_216, 1_582_248),
        ("scaffold", 8): (1_060_240, 1_688_272)}


@pytest.mark.parametrize("use_fused_sgd", [False, True])
@pytest.mark.parametrize("K,participation", [(4, 1.0), (8, 0.5)])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("algorithm", ["moon", "scaffold"])
def test_state_run_matches_reference(monkeypatch, algorithm, engine, K,
                                     participation, use_fused_sgd):
    (rm, rfl), (pm, pfl) = _state_fl(algorithm, engine, K, participation,
                                     use_fused_sgd)
    (rtr, rte), (ptr, pte) = mnist_tasks()
    ref, ref_tr = ref_run_recorded(monkeypatch, task="mnist_like",
                                   model_cfg=rm, fl=rfl, eval_every=2,
                                   train=rtr, test=rte)
    port = _port_run(pm, pfl, ptr, pte, jax_init(rm, rfl.seed), eval_every=2)
    assert_histories_equal(ref, port, len(rte))
    per_round = 2 * (2 if algorithm == "scaffold" else 1) * round(
        K * participation)
    assert [r.comm["cloud_transfers"] for r in port.history] == [
        2 * per_round, 4 * per_round]
    want = PEAK[algorithm, K][engine == "fused"]
    assert port.peak_device_bytes == ref.peak_device_bytes == want
    assert port.h2d_bytes == ref_tr.h2d_bytes > 0
    assert port.dispatches == ref_tr.dispatches
    assert_trees_close(port.final_model, ref.final_model, atol=1e-4)


def _engine_runs(algorithm, K, participation, use_fused_sgd):
    (rm, _), (pm, _) = configs(SMALL)
    _, (ptr, pte) = mnist_tasks()
    init = jax_init(rm, 0)
    return {engine: _port_run(
        pm, _state_fl(algorithm, engine, K, participation,
                      use_fused_sgd)[1][1], ptr, pte, init, eval_every=2)
        for engine in ENGINES}


@pytest.mark.parametrize("use_fused_sgd", [False, True])
@pytest.mark.parametrize("K,participation", [(4, 1.0), (8, 0.5)])
@pytest.mark.parametrize("algorithm", ["moon", "scaffold"])
def test_state_engines_agree_inside_the_port(algorithm, K, participation,
                                             use_fused_sgd):
    """The batched engine runs the fused engine's steps, reduce and state
    update on the same values, the fused block carrying the state through
    two rounds: bit-equal. The sequential engine rounds its update and
    reduce otherwise: within 1e-6."""
    runs = _engine_runs(algorithm, K, participation, use_fused_sgd)
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


@pytest.mark.parametrize("engine", ENGINES)
def test_scaffold_never_calls_fused_sgd(monkeypatch, engine):
    """With ``use_fused_sgd=True`` a SCAFFOLD run makes no ``fused_sgd``
    call under any engine (its update is momentum-free, as in the
    reference); the same MOON run makes one a step of the engine's own
    count: sequential a real step of each visit, batched the longest
    visit's steps a hop, fused the block's longest visit a round."""
    import repro_torch.core.local as local

    calls = []
    real = local.fused_sgd_lanes

    def counted(p, *a, **k):
        calls.append(p.shape[0])
        return real(p, *a, **k)

    monkeypatch.setattr(local, "fused_sgd_lanes", counted)
    _, (ptr, pte) = mnist_tasks()
    (rm, _), (pm, _) = configs(SMALL)
    n = {}
    for algorithm in ("scaffold", "moon"):
        blocks = []
        calls.clear()
        _port_run(pm, _state_fl(algorithm, engine, 8, 0.5, True)[1][1], ptr,
                  pte, jax_init(rm, 0), eval_every=2,
                  on_block=lambda t, s: blocks.append(s))
        n[algorithm] = list(calls)
    assert n["scaffold"] == []
    groups = [p.groups[0] for s in blocks for p in s.plans]
    steps = [g.lane_steps() for g in groups]
    if engine == "sequential":
        assert n["moon"] == [1] * sum(map(sum, steps))
    elif engine == "batched":
        assert n["moon"] == [g.lanes for g, s in zip(groups, steps)
                             for _ in range(max(s))]
    else:
        # each round of a block runs the block's longest visit
        want = []
        for sched in blocks:
            S = max(max(p.groups[0].lane_steps()) for p in sched.plans)
            want += [p.groups[0].lanes for p in sched.plans
                     for _ in range(S)]
        assert n["moon"] == want
    assert len(n["moon"]) > 0


# ---------------------------------------------------------------------------
# Centralized


@pytest.mark.parametrize("use_fused_sgd", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
def test_centralized_matches_reference(monkeypatch, engine, use_fused_sgd):
    """Pooled SGD over the whole fleet's shards, one visit of E epochs a
    round through ``LocalTrainer.train``, whatever the engine: histories,
    meters (no transfers), ``h2d_bytes`` and ``dispatches`` (one a step)
    equal to the reference's, no device residency, final weights within
    1e-4; ``on_block`` sees each block with no schedule."""
    (rm, rfl), (pm, pfl) = _state_fl("centralized", engine, 4, 1.0,
                                     use_fused_sgd)
    (rtr, rte), (ptr, pte) = mnist_tasks()
    ref, ref_tr = ref_run_recorded(monkeypatch, task="mnist_like",
                                   model_cfg=rm, fl=rfl, eval_every=2,
                                   train=rtr, test=rte)
    blocks = []
    port = _port_run(pm, pfl, ptr, pte, jax_init(rm, rfl.seed), eval_every=2,
                     on_block=lambda t, s: blocks.append((t, s)))
    assert blocks == [(0, None), (2, None)]
    assert_histories_equal(ref, port, len(rte))
    assert port.history[-1].comm["total_transfers"] == 0
    assert port.peak_device_bytes == ref.peak_device_bytes == 0
    # 200 pooled images in batches of 8, one epoch a round
    assert port.dispatches == ref_tr.dispatches == 4 * 25
    assert port.h2d_bytes == ref_tr.h2d_bytes
    assert_trees_close(port.final_model, ref.final_model, atol=1e-4)


@pytest.mark.parametrize("axis", ["scenario", "adversary"])
def test_centralized_refuses_scenarios_and_adversaries(axis):
    """As in the reference, a ValueError: pooled SGD has no plan for the
    transforms to act on."""
    from repro_torch.configs.base import AdversaryConfig, ScenarioConfig

    kw = ({"scenario": ScenarioConfig(drop_rate=0.5)} if axis == "scenario"
          else {"adversary": AdversaryConfig(frac=0.25)})
    _, (pm, pfl) = configs(SMALL, **fl_kwargs(algorithm="centralized", **kw))
    _, (ptr, pte) = mnist_tasks(train_per_class=4, test_per_class=1)
    with pytest.raises(ValueError, match="bypasses the RoundPlan IR"):
        _port_run(pm, pfl, ptr, pte, None)
