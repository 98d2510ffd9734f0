"""The port's paper CNN against the JAX package's.

* ``cnn_specs``: names, shapes, init kinds and the 319,178 parameters.
* Full width, C = 3 lanes of 4 images each, from the same numpy weights:
  each lane's logits, loss, penultimate features (``small_model_features``)
  and the per-lane gradients of the lane-stacked forward (one grouped
  conv over the lanes), against the reference's ``cnn_apply`` and
  ``jax.vmap(jax.value_and_grad(classifier_loss))``, within rtol 1e-5 and
  atol 1e-5 (f32, different summation orders). The grouped conv also
  agrees with ``torch.func.vmap`` of the one-model forward.
* The "SAME" 2x2 pool at even and odd image sizes, bit for bit, and a
  narrow CNN's logits at each size within 1e-5.
* ``head_param_names``/``head_grad_mask`` for both families.
* A whole fused FedSR run on ``cifar10_like`` with narrower channels
  (8, 16, 16) from the reference's initial weights, with ``use_fused_sgd``
  on and off, each against its own reference path (ROADMAP C2): eval
  rounds and comm meters exactly, every accuracy within one test sample,
  final weights within ``CNN_RUN_ATOL`` (``torch_parity``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from torch_parity import CNN_RUN_ATOL, assert_trees_close, jax_init, to_numpy

CPU = torch.device("cpu")
RTOL = ATOL = 1e-5
NARROW = {"cnn_channels": (8, 16, 16)}


def _configs(**overrides):
    from repro.configs.fedsr_cnn import CONFIG as REF
    from repro_torch.configs.fedsr_cnn import CONFIG

    return (dataclasses.replace(REF, **overrides),
            dataclasses.replace(CONFIG, **overrides))


def test_config_and_specs_match_reference():
    from repro.configs.registry import get_config as ref_get_config
    from repro.models.small import cnn_specs as ref_specs
    from repro.nn.module import param_count as ref_param_count
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.models.registry import specs_for
    from repro_torch.models.small import cnn_specs
    from repro_torch.nn.module import param_count

    rc, pc = _configs()
    assert dataclasses.asdict(get_config("fedsr-cnn")) == dataclasses.asdict(
        ref_get_config("fedsr-cnn")) == dataclasses.asdict(rc)
    assert get_smoke_config("fedsr-cnn") == pc
    ref, port = ref_specs(rc), cnn_specs(pc)
    assert list(ref) == list(port)
    for k in ref:
        assert tuple(port[k].shape) == tuple(ref[k].shape), k
        assert port[k].init == ref[k].init, k
    assert specs_for(pc) == port
    assert param_count(port) == ref_param_count(ref) == 319_178
    assert {k: int(np.prod(s.shape)) for k, s in port.items()
            if k.endswith("_w")} == {
        "conv0_w": 864, "conv1_w": 18_432, "conv2_w": 36_864,
        "fc0_w": 262_144, "fc1_w": 640}


def _lanes(rc, C, seed=0):
    """C reference-initialised lanes, biases made nonzero so their
    gradients and the bias adds are exercised."""
    rng = np.random.default_rng(seed)
    lanes = [jax_init(rc, s) for s in range(C)]
    for w in lanes:
        for k in w:
            if k.endswith("_b"):
                w[k] = (0.1 * rng.standard_normal(w[k].shape)).astype(
                    np.float32)
    return lanes


def test_full_width_forward_features_loss_and_lane_gradients():
    from repro.models.small import classifier_loss as ref_loss
    from repro.models.small import cnn_apply as ref_apply
    from repro.models.small import small_model_features as ref_features
    from repro_torch.core.local import LocalTrainer
    from repro_torch.configs.base import FLConfig
    from repro_torch.models.small import (
        cnn_apply, cnn_apply_lanes, params_from_numpy, small_model_features,
    )
    from repro_torch.utils.tree import ravel_params, unravel

    rc, pc = _configs()
    C, B = 3, 4
    lanes = _lanes(rc, C)
    rng = np.random.default_rng(1)
    images = rng.random((C, B, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, (C, B)).astype(np.int32)

    for c in range(C):
        ref_w = {k: jnp.asarray(v) for k, v in lanes[c].items()}
        port_w = params_from_numpy(lanes[c], CPU)
        x = torch.from_numpy(images[c])
        np.testing.assert_allclose(
            cnn_apply(port_w, x, pc).numpy(),
            np.asarray(ref_apply(ref_w, jnp.asarray(images[c]), rc)),
            rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            small_model_features(port_w, x, pc).numpy(),
            np.asarray(ref_features(ref_w, jnp.asarray(images[c]), rc)),
            rtol=RTOL, atol=ATOL)

    stacked = {k: jnp.stack([w[k] for w in lanes]) for k in lanes[0]}
    ref_l, ref_g = jax.vmap(jax.value_and_grad(
        lambda p, x, y: ref_loss(p, {"images": x, "labels": y}, rc)))(
        stacked, jnp.asarray(images), jnp.asarray(labels))

    trainer = LocalTrainer(pc, FLConfig(), CPU)
    flat = torch.stack([ravel_params(params_from_numpy(w, CPU))
                        for w in lanes])
    assert flat.shape == (C, 319_178)
    losses, grads = trainer.lane_grads(
        flat, {"images": torch.from_numpy(images),
               "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_l),
                               rtol=RTOL, atol=ATOL)
    names = [k for k, _ in trainer.layout]
    assert len(names) == 10
    assert_trees_close(dict(zip(names, grads)), ref_g, atol=ATOL, rtol=RTOL)

    # the grouped conv over the lanes against torch.func.vmap of the
    # one-model forward
    leaves = unravel(flat, trainer.layout)
    by_vmap = torch.func.vmap(lambda p, x: cnn_apply(p, x, pc))(
        leaves, torch.from_numpy(images))
    grouped = cnn_apply_lanes(leaves, torch.from_numpy(images), pc)
    np.testing.assert_allclose(grouped.numpy(), by_vmap.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("size", [7, 8, 15, 28, 32])
def test_pool_and_narrow_cnn_at_even_and_odd_sizes(size):
    """The "SAME" 2x2/2 pool is ``max_pool2d(ceil_mode=True)`` on NCHW,
    bit for bit, and the CNN's fc0 width and logits follow the ceil
    division at every size."""
    from repro.models.small import _maxpool2 as ref_pool
    from repro.models.small import cnn_apply as ref_apply
    from repro_torch.models.small import (
        _maxpool2, cnn_apply, cnn_specs, params_from_numpy,
    )

    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    want = np.asarray(ref_pool(jnp.asarray(x)))
    got = _maxpool2(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, (size + 1) // 2, (size + 1) // 2, 5)
    np.testing.assert_array_equal(got, want)

    rc, pc = _configs(image_size=size, cnn_channels=(4, 8, 8))
    s = (((size + 1) // 2) + 1) // 2
    assert cnn_specs(pc)["fc0_w"].shape == (s * s * 8, 64)
    w = jax_init(rc)
    imgs = rng.random((3, size, size, 3), dtype=np.float32)
    np.testing.assert_allclose(
        cnn_apply(params_from_numpy(w, CPU), torch.from_numpy(imgs),
                  pc).numpy(),
        np.asarray(ref_apply({k: jnp.asarray(v) for k, v in w.items()},
                             jnp.asarray(imgs), rc)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("family", ["cnn", "mlp"])
def test_head_grad_mask_matches_reference(family):
    from repro.configs.fedsr_mlp import CONFIG as REF_MLP
    from repro.models.small import head_grad_mask as ref_mask
    from repro.models.small import head_param_names as ref_names
    from repro_torch.configs.fedsr_mlp import CONFIG as MLP
    from repro_torch.models.small import (
        head_grad_mask, head_param_names, params_from_numpy,
    )

    rc, pc = _configs() if family == "cnn" else (REF_MLP, MLP)
    w = jax_init(rc)
    assert head_param_names(pc) == ref_names(rc)
    mask = head_grad_mask(params_from_numpy(w, CPU), pc)
    want = to_numpy(ref_mask({k: jnp.asarray(v) for k, v in w.items()}, rc))
    assert sorted(mask) == sorted(want)
    for k in want:
        assert mask[k].dtype == torch.float32
        np.testing.assert_array_equal(mask[k].numpy(), want[k])
    assert sum(float(m.sum()) for m in mask.values()) == sum(
        int(np.prod(w[k].shape)) for k in ref_names(rc))


@pytest.mark.parametrize("use_fused_sgd", [True, False])
def test_whole_fused_cnn_run_matches_reference(use_fused_sgd):
    from repro.configs.base import FLConfig as RefFL
    from repro.core.executor import run_experiment as ref_run
    from repro.data.synthetic import make_task as ref_make_task
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.executor import run_experiment
    from repro_torch.data.synthetic import make_task

    rc, pc = _configs(**NARROW)
    kw = dict(algorithm="fedsr", engine="fused", num_devices=4, num_edges=2,
              ring_rounds=2, rounds=4, batch_size=8,
              partition="pathological", use_fused_sgd=use_fused_sgd)
    rtr, rte = ref_make_task("cifar10_like", train_per_class=16,
                             test_per_class=4)
    ptr, pte = make_task("cifar10_like", train_per_class=16,
                         test_per_class=4)
    ref = ref_run(task="cifar10_like", model_cfg=rc, fl=RefFL(**kw),
                  eval_every=2, train=rtr, test=rte)
    port = run_experiment(task="cifar10_like", model_cfg=pc,
                          fl=FLConfig(**kw), eval_every=2, train=ptr,
                          test=pte, init_params=jax_init(rc), device="cpu")
    assert [r.round for r in ref.history] == [r.round for r in port.history]
    for a, b in zip(ref.history, port.history):
        assert abs(a.accuracy - b.accuracy) <= 1.0 / len(rte) + 1e-6
        assert a.comm == b.comm
    assert port.dispatches == 2
    assert_trees_close(port.final_model, ref.final_model, atol=CNN_RUN_ATOL)
