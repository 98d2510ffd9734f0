"""The port's classifier fleet serving (``repro_torch.serve.fleet``)
against the JAX package's ``serve/fleet.py``.

* ``FleetClassifier`` and ``loop_classify`` against the reference's, with
  the reference's weights carried in as numpy: within 1e-5 for the paper
  MLP and a narrow CNN.
* Inside the port: the stacked forward against the per-model loop within
  1e-5, each request's logits against its own model's solo forward, one
  dispatch a batch, and device-resident against host-resident serving
  bit for bit, with and without ``prefetch``.
* The host-resident fleet's staging: the cohort's rows, the prefetch's
  accounting, a failure of the staging thread raised by ``rows``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from torch_parity import to_numpy

K = 6
CPU = "cpu"
NARROW_CNN = {"cnn_channels": (4, 8, 8)}


def _cfgs(family):
    if family == "mlp":
        from repro.configs.fedsr_mlp import CONFIG as REF
        from repro_torch.configs.fedsr_mlp import CONFIG
        return REF, CONFIG
    from repro.configs.fedsr_cnn import CONFIG as REF
    from repro_torch.configs.fedsr_cnn import CONFIG
    return (dataclasses.replace(REF, **NARROW_CNN),
            dataclasses.replace(CONFIG, **NARROW_CNN))


def _fleet_trees(ref_cfg, k=K):
    """K distinct models drawn by the reference, as numpy dicts."""
    from repro.models.small import init_small_model

    return [to_numpy(init_small_model(jax.random.PRNGKey(i), ref_cfg))
            for i in range(k)]


def _batch(cfg, n, seed, k=K, distinct=False):
    rng = np.random.default_rng(seed)
    lanes = (rng.choice(k, size=n, replace=False) if distinct
             else rng.integers(0, k, size=n))
    # pixels in [0, 1), as the tasks' images are
    images = rng.random(
        (n, cfg.image_size, cfg.image_size, cfg.image_channels),
        dtype=np.float32)
    return lanes, images


def test_fleet_params_validate_their_input():
    from repro_torch.serve.fleet import FleetParams

    with pytest.raises(ValueError):
        FleetParams({}, device=CPU)
    with pytest.raises(ValueError):
        FleetParams.from_trees([], device=CPU)
    with pytest.raises(ValueError, match="same K"):
        FleetParams({"a": np.zeros((2, 3)), "b": np.zeros((3, 3))},
                    device=CPU)
    with pytest.raises(ValueError, match=r"\(K, 5\)"):
        FleetParams.from_arena(np.zeros((2, 4), np.float32), (("a", (5,)),),
                               device=CPU)
    fleet = FleetParams({"a": np.zeros((2, 3))}, device=CPU)
    with pytest.raises(IndexError):
        fleet.rows([0, 2])


def test_a_fleet_without_a_device_argument_needs_the_gpu(monkeypatch):
    from repro_torch.serve.fleet import FleetParams

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetParams({"a": np.zeros((2, 3))})


@pytest.mark.parametrize("family", ["mlp", "cnn"])
def test_classifier_matches_the_reference(family):
    import jax.numpy as jnp

    from repro.serve.fleet import (
        FleetClassifier as RefClassifier, FleetParams as RefParams,
        loop_classify as ref_loop,
    )
    from repro_torch.serve.fleet import (
        FleetClassifier, FleetParams, loop_classify,
    )

    ref_cfg, cfg = _cfgs(family)
    trees = _fleet_trees(ref_cfg)
    lanes, images = _batch(cfg, 10, 1)
    ref = np.asarray(RefClassifier(ref_cfg)(RefParams.from_trees(
        [{k: jnp.asarray(v) for k, v in t.items()} for t in trees]),
        lanes, images))
    ref_l = np.asarray(ref_loop(ref_cfg, RefParams.from_trees(trees), lanes,
                                images))
    fleet = FleetParams.from_trees(trees, device=CPU)
    clf = FleetClassifier(cfg)
    out = clf(fleet, lanes, images)
    assert out.shape == (10, cfg.num_classes) and clf.dispatches == 1
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(loop_classify(cfg, fleet, lanes, images)
                               .numpy(), ref_l, atol=1e-5)


@pytest.mark.parametrize("family", ["mlp", "cnn"])
def test_stacked_against_loop_and_solo_routing(family):
    from repro_torch.models.small import small_model_apply
    from repro_torch.serve.fleet import (
        FleetClassifier, FleetParams, loop_classify,
    )

    ref_cfg, cfg = _cfgs(family)
    trees = _fleet_trees(ref_cfg)
    lanes, images = _batch(cfg, 16, 2)
    assert len(np.unique(lanes)) > 1
    fleet = FleetParams.from_trees(trees, device=CPU)
    clf = FleetClassifier(cfg)
    out = clf(fleet, lanes, images)
    loop = loop_classify(cfg, fleet, lanes, images)
    np.testing.assert_allclose(out.numpy(), loop.numpy(), atol=1e-5)
    for b in range(len(lanes)):
        model = {k: torch.tensor(v) for k, v in trees[lanes[b]].items()}
        solo = small_model_apply(model, torch.from_numpy(images[b:b + 1]),
                                 cfg)[0]
        np.testing.assert_allclose(out[b].numpy(), solo.numpy(), atol=1e-5)
    # every request's row is its own model's, not a neighbour's
    other = (lanes + 1) % K
    assert np.abs(out.numpy() - clf(fleet, other, images).numpy()).max() > 1e-3
    assert clf.dispatches == 2


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("family", ["mlp", "cnn"])
def test_host_residency_is_bit_equal_to_device(family, prefetch):
    from repro_torch.serve.fleet import FleetClassifier, FleetParams

    ref_cfg, cfg = _cfgs(family)
    trees = _fleet_trees(ref_cfg)
    batches = [_batch(cfg, 8, s) for s in range(3)]
    clf = FleetClassifier(cfg)
    dev = FleetParams.from_trees(trees, device=CPU)
    host = FleetParams.from_trees(trees, resident=False, device=CPU)
    try:
        for i, (lanes, images) in enumerate(batches):
            got = clf(host, lanes, images)
            # the next batch's cohort stages while this batch is served
            if prefetch and i + 1 < len(batches):
                host.prefetch(batches[i + 1][0])
            assert torch.equal(got, clf(dev, lanes, images))
            stack, local = host.rows(lanes)
            assert stack.shape[0] == len(np.unique(lanes))
            assert torch.equal(stack[local], dev.rows(lanes)[0][lanes])
    finally:
        host.close()
    assert host.stage_seconds > 0
    assert (host.overlapped_stage_seconds > 0) == prefetch
    assert dev.stage_seconds == 0


def test_prefetch_accounting_and_stale_prefetch():
    from repro_torch.serve.fleet import FleetParams

    arena = np.arange(5 * 3, dtype=np.float32).reshape(5, 3)
    host = FleetParams.from_arena(arena, (("a", (3,)),), resident=False,
                                  device=CPU)
    try:
        host.prefetch([1, 3])
        host.prefetch([1, 3, 1])        # the same cohort: nothing new
        stack, local = host.rows([3, 1, 3])
        np.testing.assert_array_equal(stack.numpy(), arena[[1, 3]])
        np.testing.assert_array_equal(local.numpy(), [1, 0, 1])
        assert host.overlapped_stage_seconds == host.stage_seconds > 0
        host.prefetch([0])              # stale: another set comes
        stack, _ = host.rows([4, 2])
        np.testing.assert_array_equal(stack.numpy(), arena[[2, 4]])
        assert host.stage_seconds > host.overlapped_stage_seconds
        before = host.stage_seconds
        host.rows([2, 4])               # resident cohort: no staging
        assert host.stage_seconds == before
        assert torch.equal(host.model(4)["a"], torch.from_numpy(arena[4]))
    finally:
        host.close()
        host.close()


def test_a_staging_failure_is_raised_by_rows(monkeypatch):
    from repro_torch.serve.fleet import FleetParams

    host = FleetParams({"a": np.zeros((4, 3))}, resident=False, device=CPU)

    def broken(ids, pinned):
        raise MemoryError("page-locked allocation failed")

    monkeypatch.setattr(host._stager, "_build_fn", broken)
    host.prefetch([0, 1])
    with pytest.raises(MemoryError, match="page-locked"):
        host.rows([0, 1])
    host.close()


def test_serving_the_personalized_fleet_from_its_arena():
    from repro_torch.core.personalize import fleet_views
    from repro_torch.serve.fleet import FleetClassifier, FleetParams

    ref_cfg, cfg = _cfgs("mlp")
    trees = _fleet_trees(ref_cfg)
    names = sorted(trees[0])
    arena = np.stack([np.concatenate([t[k].reshape(-1) for k in names])
                      for t in trees])
    layout = tuple((k, trees[0][k].shape) for k in names)
    views = fleet_views(arena, layout)
    for k in names:
        np.testing.assert_array_equal(views[k][2], trees[2][k])
    lanes, images = _batch(cfg, 6, 4, distinct=True)
    clf = FleetClassifier(cfg)
    a = clf(FleetParams.from_arena(arena, layout, device=CPU), lanes, images)
    b = clf(FleetParams.from_trees(trees, device=CPU), lanes, images)
    assert torch.equal(a, b)
