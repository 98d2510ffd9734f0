"""The port's FedSR main path, and the FedAvg, FedProx, Ring and HierFAVG
baselines, against the JAX package's.

* Host side, exactly: configs, ``make_task``, the partitions,
  ``plan_epoch_indices``/``stack_plan_indices``, the data plane's bytes,
  every ported planner's ``plan_schedule`` and the fused engine's stacked
  block arrays (HierFAVG's ``_stack_hier_schedule`` and MOON's and
  SCAFFOLD's state lanes too), comm meters, ``h2d_bytes`` and
  ``dispatches``.
* One SGD step of the full-width paper MLP: per-lane loss and gradients
  within 1e-5 (f32, different summation orders), with the plain loss and
  with FedProx's.
* Whole runs of a narrow MLP through ``run_experiment`` from the
  reference's initial weights, with ``use_fused_sgd`` on and off (each held
  against its own reference path), for FedSR, FedAvg, FedProx, Ring and
  HierFAVG: final weights within 1e-4 and every eval's accuracy within one
  test sample.
* Port rules: the port imports nothing of JAX or of the JAX package, and
  options it does not run yet raise.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from torch_parity import (
    SMALL, assert_schedules_equal, assert_trees_close, configs, fl_kwargs,
    jax_init, mnist_tasks,
)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
_fl = fl_kwargs
_tasks = mnist_tasks


# ---------------------------------------------------------------------------
# host side, exactly


@pytest.mark.parametrize("name", ["ModelConfig", "FLConfig", "ScenarioConfig",
                                  "AdversaryConfig", "PersonalizeConfig"])
def test_config_copies_have_the_reference_fields_and_defaults(name):
    import repro.configs.base as ref
    import repro_torch.configs.base as port

    def fields(cls):
        return {f.name: (f.default if f.default is not dataclasses.MISSING
                         else f.default_factory()
                         if f.default_factory is not dataclasses.MISSING
                         else None)
                for f in dataclasses.fields(cls)}

    rf, pf = fields(getattr(ref, name)), fields(getattr(port, name))
    assert list(rf) == list(pf)
    for k in rf:
        if dataclasses.is_dataclass(rf[k]):
            assert dataclasses.asdict(rf[k]) == dataclasses.asdict(pf[k]), k
        else:
            assert rf[k] == pf[k], k


@pytest.mark.parametrize("scheme", ["iid", "pathological", "dirichlet"])
def test_task_and_partition_are_identical(scheme):
    from repro.data.pipeline import make_clients as ref_make_clients
    from repro_torch.data.pipeline import make_clients

    (rtr, rte), (ptr, pte) = _tasks()
    for a, b in ((rtr, ptr), (rte, pte)):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    rc = ref_make_clients(rtr, scheme=scheme, num_devices=6,
                          rng=np.random.default_rng(3), alpha=0.5)
    pc = make_clients(ptr, scheme=scheme, num_devices=6,
                      rng=np.random.default_rng(3), alpha=0.5)
    for a, b in zip(rc, pc):
        assert a.client_id == b.client_id
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.images, b.images)


def test_batch_plans_and_index_stacks_are_identical():
    from repro.data.pipeline import ClientData as RefClient
    from repro.data.pipeline import plan_epoch_indices as ref_plan
    from repro.data.pipeline import stack_plan_indices as ref_stack
    from repro_torch.data.pipeline import (
        ClientData, plan_epoch_indices, stack_plan_indices,
    )

    labels = np.arange(37) % 10
    imgs = np.zeros((37, 2, 2, 1), np.float32)
    rr, pr = np.random.default_rng(5), np.random.default_rng(5)
    ref_plans, port_plans = [], []
    for n in (37, 8, 5):
        a = ref_plan(RefClient(0, imgs[:n], labels[:n]), 8, 2, rr)
        b = plan_epoch_indices(ClientData(0, imgs[:n], labels[:n]), 8, 2, pr)
        np.testing.assert_array_equal(a, b)
        ref_plans.append(a)
        port_plans.append(b)
    for plans in ([ref_plans, port_plans],
                  [ref_plans[:1] + [None], port_plans[:1] + [None]]):
        ra = ref_stack(plans[0], list(range(len(plans[0]))), pad_to=4,
                       steps=12)
        pa = stack_plan_indices(plans[1], list(range(len(plans[1]))),
                                pad_to=4, steps=12)
        for x, y in zip(ra, pa):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_cosine_decay_matches_up_to_the_cosine_rounding():
    """The port evaluates the schedule in float32 step by step, as XLA
    does; only XLA's float32 cosine is not correctly rounded. Its error (an
    ulp of a value below 1, <= 2**-23) is scaled by the half span
    0.5*(init - final), plus one rounding of the result."""
    from repro.optim.schedules import cosine_decay as ref_cosine
    from repro_torch.optim.schedules import cosine_decay

    for T in (4, 10, 50, 1000):
        ref_fn, fn = ref_cosine(0.01, 1e-5, T), cosine_decay(0.01, 1e-5, T)
        ref = np.asarray([float(ref_fn(t)) for t in range(T + 2)], np.float32)
        got = np.asarray([fn(t) for t in range(T + 2)], np.float32)
        np.testing.assert_allclose(got, ref, rtol=2.0**-23,
                                   atol=0.5 * (0.01 - 1e-5) * 2.0**-23)


def _planners(participation, algorithm="fedsr", **fl_kw):
    """The ``algorithm`` planner of each package over identical clients."""
    from repro.core.algorithms import make_algorithm as ref_make_algorithm
    from repro.core.local import LocalTrainer as RefTrainer
    from repro.data.pipeline import make_clients as ref_make_clients
    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.core.local import LocalTrainer
    from repro_torch.data.pipeline import make_clients

    (rm, rfl), (pm, pfl) = configs(SMALL, **_fl(
        num_devices=8, num_edges=2, participation=participation, **fl_kw))
    (rtr, _), (ptr, _) = _tasks()
    rc = ref_make_clients(rtr, scheme="dirichlet", num_devices=8,
                          rng=np.random.default_rng(0), alpha=0.5)
    pc = make_clients(ptr, scheme="dirichlet", num_devices=8,
                      rng=np.random.default_rng(0), alpha=0.5)
    ref = ref_make_algorithm(algorithm, RefTrainer(rm, rfl), rc, rfl)
    port = make_algorithm(algorithm, LocalTrainer(pm, pfl, CPU), pc, pfl)
    return ref, port


@pytest.mark.parametrize("participation", [1.0, 0.75])
def test_fedsr_schedule_and_block_arrays_are_identical(participation):
    """Same seed -> same rings, batch plans, weights and comm; and the fused
    engine stacks them into identical block arrays (participation 0.75
    draws rings of uneven size: all-invalid ring-tail hops)."""
    ref, port = _planners(participation)
    rr, pr = np.random.default_rng(7), np.random.default_rng(7)
    lrs = np.asarray([0.05, 0.04, 0.03])
    rs = ref.plan_schedule(0, 3, rr, {})
    ps = port.plan_schedule(0, 3, pr, {})
    assert_schedules_equal(rs, ps)
    np.testing.assert_array_equal(rs.visited(), ps.visited())
    rxs = ref.engine._stack_cohort_schedule(rs.plans, lrs, "plain", {})
    pxs = port.engine._stack_cohort_schedule(ps.plans, lrs)
    assert sorted(rxs) == sorted(pxs)
    for k in rxs:
        assert rxs[k].dtype == pxs[k].dtype, k
        np.testing.assert_array_equal(rxs[k], pxs[k], err_msg=k)
    assert rr.bit_generator.state == pr.bit_generator.state


@pytest.mark.parametrize("algorithm,participation,reshuffle", [
    ("fedavg", 1.0, True), ("fedavg", 0.5, True),
    ("ring", 1.0, True), ("ring", 0.75, False),
    ("fedprox", 1.0, True), ("fedprox", 0.5, True)])
def test_baseline_schedule_and_block_arrays_are_identical(
        algorithm, participation, reshuffle):
    """FedAvg: one hop of every sampled client, step counts padded per
    lane by ``stack_plan_indices`` to the block's longest plan, |D_i|/|D|
    weights. FedProx: FedAvg's plans with the ``"prox"`` loss and the
    global model as its shared anchor. Ring: one global ring over the
    sampled devices, optionally reshuffled (one more draw), R laps as
    hops. Same seed -> identical plans, comm, block arrays and RNG
    state."""
    ref, port = _planners(participation, algorithm,
                          reshuffle_ring=reshuffle, local_epochs=2)
    rr, pr = np.random.default_rng(7), np.random.default_rng(7)
    lrs = np.asarray([0.05, 0.04, 0.03])
    rs = ref.plan_schedule(0, 3, rr, {})
    ps = port.plan_schedule(0, 3, pr, {})
    assert_schedules_equal(rs, ps)
    assert rr.bit_generator.state == pr.bit_generator.state
    np.testing.assert_array_equal(rs.visited(), ps.visited())
    variant = ps.plans[0].groups[0].variant
    rxs = ref.engine._stack_cohort_schedule(rs.plans, lrs, variant, {})
    pxs = port.engine._stack_cohort_schedule(ps.plans, lrs)
    assert sorted(rxs) == sorted(pxs)
    for k in pxs:
        assert rxs[k].dtype == pxs[k].dtype, k
        np.testing.assert_array_equal(rxs[k], pxs[k], err_msg=k)
    if algorithm == "fedprox":
        from repro_torch.core.plan import GLOBAL

        assert {(g.variant, tuple(g.shared_extras.items()))
                for p in ps.plans for g in p.groups} == {
            ("prox", (("anchor", GLOBAL),))}
    if algorithm == "fedavg":
        steps = pxs["valid"].sum(-1)                # (n, H=1, C)
        assert pxs["valid"].shape[1] == 1 and len(set(steps.ravel())) > 1


@pytest.mark.parametrize("participation", [1.0, 0.5])
def test_hieravg_schedule_and_block_arrays_are_identical(participation):
    """HierFAVG at K=8, M=2, R=3: each edge samples its devices (sorted,
    no reshuffle), the (edge, device) pairs are the lanes of R chained
    groups, groups 1.. seed from their edge, only the last collapses, and
    every edge records cloud and edge transfers. Same seed -> identical
    plans, comm, RNG state and every array of ``_stack_hier_schedule``,
    byte for byte."""
    ref, port = _planners(participation, "hieravg", ring_rounds=3)
    rr, pr = np.random.default_rng(7), np.random.default_rng(7)
    lrs = np.asarray([0.05, 0.04, 0.03])
    rs = ref.plan_schedule(0, 3, rr, {})
    ps = port.plan_schedule(0, 3, pr, {})
    assert_schedules_equal(rs, ps)
    assert rr.bit_generator.state == pr.bit_generator.state
    np.testing.assert_array_equal(rs.visited(), ps.visited())
    lanes = 2 * max(1, round(4 * participation))
    for plan in ps.plans:
        assert [g.agg.collapsed for g in plan.groups] == [False, False, True]
        assert plan.groups[0].seed is None
        assert plan.groups[1].seed == plan.groups[2].seed == tuple(
            sorted([0, 1] * (lanes // 2)))
        assert [c for c, _ in plan.comm] == [
            "cloud_down", "edge_down", "edge_up", "cloud_up"] * 2
        assert sum(n for c, n in plan.comm if c.startswith("edge")) == \
            2 * 3 * lanes
    rxs = ref.engine._stack_hier_schedule(rs.plans, lrs)
    pxs = port.engine._stack_hier_schedule(ps.plans, lrs)
    assert sorted(rxs) == sorted(pxs) == [
        "aggv", "lr", "plans", "rows", "seed", "valid", "wg"]
    for k in pxs:
        assert rxs[k].dtype == pxs[k].dtype, k
        assert rxs[k].shape == pxs[k].shape, k
        assert rxs[k].tobytes() == pxs[k].tobytes(), k
    assert pxs["wg"].shape == (3, 2, lanes)


@pytest.mark.parametrize("participation", [1.0, 0.5])
@pytest.mark.parametrize("algorithm", ["moon", "scaffold"])
def test_state_schedule_and_block_arrays_are_identical(algorithm,
                                                       participation):
    """MOON and SCAFFOLD at K=8: FedAvg's cohort draws, MOON's
    ``{"w_glob": GLOBAL}`` and per-lane ``StateRef("prev", i,
    fallback_global=True)``, SCAFFOLD's ``StateRef("c")``/``("ci", i)`` and
    its two transfers a client each way, ``keep_locals`` on. Same seed ->
    identical plans, comm and RNG state, and every array of the fused
    block byte for byte: the state lanes ``ids``, MOON's ``use_prev``
    (from a ``seen`` mask that already holds clients 0, 2 and 5 and
    advances round by round inside the block, so later rounds of a
    participation-0.5 block mix seen and unseen lanes), SCAFFOLD's ``kl``
    (products rounded from float64), ``mw`` and ``frac``."""
    ref, port = _planners(participation, algorithm)
    rr, pr = np.random.default_rng(7), np.random.default_rng(7)
    # learning rates of the cosine schedule, whose K_i * lr products
    # round differently in float32 and float64
    lrs = np.asarray([0.01, 0.0099862953475457, 0.009945218953682733])
    rs = ref.plan_schedule(0, 3, rr, {})
    ps = port.plan_schedule(0, 3, pr, {})
    assert_schedules_equal(rs, ps)
    assert rr.bit_generator.state == pr.bit_generator.state
    n_lanes = max(1, round(8 * participation))
    for plan in ps.plans:
        (grp,) = plan.groups
        assert grp.keep_locals and grp.variant == algorithm
        assert len(grp.hops) == 1 and grp.lanes == n_lanes
        per = 2 if algorithm == "scaffold" else 1
        assert plan.comm == (("cloud_down", per * n_lanes),
                             ("cloud_up", per * n_lanes))
    seen = np.zeros(9, bool)
    seen[[0, 2, 5]] = True
    rxs = ref.engine._stack_cohort_schedule(rs.plans, lrs, algorithm,
                                            {"seen": seen.copy()})
    pxs = port.engine._stack_cohort_schedule(ps.plans, lrs, algorithm,
                                             {"seen": seen.copy()})
    want = {"moon": ["use_prev"], "scaffold": ["frac", "kl", "mw"]}
    assert sorted(rxs) == sorted(pxs) == sorted(
        ["aggv", "ids", "lr", "plans", "rows", "valid"] + want[algorithm])
    for k in pxs:
        assert rxs[k].dtype == pxs[k].dtype, k
        assert rxs[k].shape == pxs[k].shape, k
        assert rxs[k].tobytes() == pxs[k].tobytes(), k
    if algorithm == "moon" and participation < 1.0:
        # round 0 reads the mask as given; later rounds see the block's
        # own earlier clients
        assert pxs["use_prev"][0].tolist() == seen[
            list(ps.plans[0].groups[0].hops[0].ids)].tolist()
        assert pxs["use_prev"][1:].any() and not pxs["use_prev"].all()
    if algorithm == "scaffold":
        steps = np.asarray(ps.plans[0].groups[0].lane_steps())
        assert pxs["kl"][0].tolist() == [np.float32(k * lrs[0])
                                         for k in steps]


def test_blocks_meter_identically_and_train_alike():
    """Two blocks through ``run_schedule`` in both packages from the same
    weights: identical comm meters, ``h2d_bytes``, ``dispatches`` (one per
    block) and data-plane bytes; the trained global model within 1e-4."""
    from repro.core.comm import CommMeter as RefMeter
    from repro_torch.core.comm import CommMeter
    from repro_torch.models.small import params_from_numpy
    from repro_torch.utils.tree import layout_of, ravel_params, unravel

    ref, port = _planners(1.0)
    w0 = jax_init(ref.trainer.cfg)
    rw = jax.tree.map(jnp.asarray, w0)
    params = params_from_numpy(w0, CPU)
    pw = ravel_params(params)
    rmeter, pmeter = RefMeter(model_bytes=4), CommMeter(model_bytes=4)
    rr, pr = np.random.default_rng(1), np.random.default_rng(1)
    for t0, lrs in ((0, [0.05, 0.04]), (2, [0.03])):
        rw, _ = ref.run_schedule(rw, t0, np.asarray(lrs), rr, rmeter, {})
        pw, _ = port.run_schedule(pw, t0, np.asarray(lrs), pr, pmeter, {})
    assert rmeter.snapshot() == pmeter.snapshot()
    assert ref.trainer.h2d_bytes == port.trainer.h2d_bytes > 0
    assert ref.trainer.dispatches == port.trainer.dispatches == 2
    assert ref.engine.plane.nbytes == port.engine.plane.nbytes
    assert ref.residency.peak_bytes == port.residency.peak_bytes
    assert_trees_close(unravel(pw, layout_of(params)), rw, atol=1e-4)


# ---------------------------------------------------------------------------
# one SGD step of the full-width paper MLP


def test_full_width_mlp_step_loss_and_lane_gradients():
    from repro.models.small import classifier_loss as ref_loss
    from repro_torch.core.local import LocalTrainer
    from repro_torch.models.small import params_from_numpy
    from repro_torch.utils.tree import ravel_params, unravel

    (rm, _), (pm, pfl) = configs()
    C, B = 3, 16
    lanes = [jax_init(rm, seed) for seed in range(C)]
    rng = np.random.default_rng(0)
    images = rng.random((C, B, 28, 28, 1), dtype=np.float32)
    labels = rng.integers(0, 10, (C, B)).astype(np.int32)

    stacked = {k: jnp.stack([w[k] for w in lanes]) for k in lanes[0]}
    ref_l, ref_g = jax.vmap(jax.value_and_grad(
        lambda p, x, y: ref_loss(p, {"images": x, "labels": y}, rm)))(
        stacked, jnp.asarray(images), jnp.asarray(labels))

    trainer = LocalTrainer(pm, pfl, CPU)
    flat = torch.stack([ravel_params(params_from_numpy(w, CPU))
                        for w in lanes])
    assert flat.shape == (C, 199_210)
    losses, grads = trainer.lane_grads(
        flat, {"images": torch.from_numpy(images),
               "labels": torch.from_numpy(labels)})
    # autograd's leaves, in layout order, each a contiguous (C, *shape)
    # tensor that the fused update reads in place
    assert [tuple(g.shape) for g in grads] == [
        (C, *shape) for _, shape in trainer.layout]
    assert all(g.is_contiguous() for g in grads)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_l), atol=1e-5)
    assert_trees_close(dict(zip((k for k, _ in trainer.layout), grads)),
                       ref_g, atol=1e-5)
    # the step itself, from zero momentum at a visit start: p - lr * g
    lr = 0.05
    trainer._update(flat, grads, torch.zeros_like(flat),
                    torch.ones(C, dtype=torch.bool), torch.tensor([lr]),
                    reset=True)
    want = {k: stacked[k] - lr * ref_g[k] for k in stacked}
    assert_trees_close(unravel(flat, trainer.layout), want, atol=1e-5)


def test_full_width_mlp_prox_step_loss_and_lane_gradients():
    """FedProx's loss at full width: the reference's own ``prox_loss``
    (vmapped over lanes, the anchor shared) against ``lane_grads`` with the
    anchor, within 1e-5; the proximal term moves the gradient far beyond
    that bound (a control against an anchor that is dropped)."""
    from repro.core.local import LocalTrainer as RefTrainer
    from repro_torch.core.local import LocalTrainer
    from repro_torch.models.small import params_from_numpy
    from repro_torch.utils.tree import ravel_params

    (rm, rfl), (pm, pfl) = configs()
    assert pfl.mu == rfl.mu == 0.01
    C, B = 3, 16
    lanes = [jax_init(rm, seed) for seed in range(C)]
    anchor = jax_init(rm, 7)
    rng = np.random.default_rng(1)
    images = rng.random((C, B, 28, 28, 1), dtype=np.float32)
    labels = rng.integers(0, 10, (C, B)).astype(np.int32)

    prox_loss = RefTrainer(rm, rfl)._many_spec["prox"][0]
    stacked = {k: jnp.stack([w[k] for w in lanes]) for k in lanes[0]}
    ref_l, ref_g = jax.jit(jax.vmap(
        jax.value_and_grad(lambda p, x, y, a: prox_loss(
            p, {"images": x, "labels": y}, a)),
        in_axes=(0, 0, 0, None)))(
        stacked, jnp.asarray(images), jnp.asarray(labels),
        jax.tree.map(jnp.asarray, anchor))

    trainer = LocalTrainer(pm, pfl, CPU)
    flat = torch.stack([ravel_params(params_from_numpy(w, CPU))
                        for w in lanes])
    batch = {"images": torch.from_numpy(images),
             "labels": torch.from_numpy(labels)}
    w_anchor = ravel_params(params_from_numpy(anchor, CPU))
    losses, grads = trainer.lane_grads(flat, batch, w_anchor)
    names = [k for k, _ in trainer.layout]
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_l), atol=1e-5)
    assert_trees_close(dict(zip(names, grads)), ref_g, atol=1e-5)
    plain_l, plain_g = trainer.lane_grads(flat, batch)
    moved = max(float((a - b).abs().max()) for a, b in zip(grads, plain_g))
    assert moved > 100 * 1e-5, moved
    assert float((losses - plain_l).min()) > 100 * 1e-5


# ---------------------------------------------------------------------------
# whole runs


@pytest.mark.parametrize("use_fused_sgd", [True, False])
def test_whole_run_matches_reference(use_fused_sgd):
    from repro.core.executor import run_experiment as ref_run
    from repro_torch.core.executor import run_experiment

    (rm, rfl), (pm, pfl) = configs(SMALL, **_fl(use_fused_sgd=use_fused_sgd))
    (rtr, rte), (ptr, pte) = _tasks()
    ref = ref_run(task="mnist_like", model_cfg=rm, fl=rfl, eval_every=2,
                  train=rtr, test=rte)
    port = run_experiment(task="mnist_like", model_cfg=pm, fl=pfl,
                          eval_every=2, train=ptr, test=pte,
                          init_params=jax_init(rm, rfl.seed), device="cpu")
    assert [r.round for r in ref.history] == [r.round for r in port.history]
    for a, b in zip(ref.history, port.history):
        assert abs(a.accuracy - b.accuracy) <= 1.0 / len(rte) + 1e-6
        assert a.comm == b.comm
        assert a.rounds == b.rounds
        assert np.float32(a.lr) == np.float32(b.lr)
    assert port.dispatches == 2
    assert_trees_close(port.final_model, ref.final_model, atol=1e-4)


@pytest.mark.parametrize("algorithm", ["fedavg", "ring", "fedprox",
                                       "hieravg"])
@pytest.mark.parametrize("use_fused_sgd", [True, False])
def test_baseline_run_matches_reference(algorithm, use_fused_sgd):
    from repro.core.executor import run_experiment as ref_run
    from repro_torch.core.executor import run_experiment

    (rm, rfl), (pm, pfl) = configs(SMALL, **_fl(
        algorithm=algorithm, use_fused_sgd=use_fused_sgd, participation=0.75))
    (rtr, rte), (ptr, pte) = _tasks()
    ref = ref_run(task="mnist_like", model_cfg=rm, fl=rfl, eval_every=2,
                  train=rtr, test=rte)
    port = run_experiment(task="mnist_like", model_cfg=pm, fl=pfl,
                          eval_every=2, train=ptr, test=pte,
                          init_params=jax_init(rm, rfl.seed), device="cpu")
    assert [r.round for r in ref.history] == [r.round for r in port.history]
    for a, b in zip(ref.history, port.history):
        assert abs(a.accuracy - b.accuracy) <= 1.0 / len(rte) + 1e-6
        assert a.comm == b.comm
        assert np.float32(a.lr) == np.float32(b.lr)
    assert port.dispatches == 2
    assert ref.peak_device_bytes == port.peak_device_bytes
    assert_trees_close(port.final_model, ref.final_model, atol=1e-4)


# ---------------------------------------------------------------------------
# port rules

_PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)\b",
                        re.MULTILINE)


def test_port_sources_import_nothing_of_jax_or_the_reference():
    offenders = [str(f.relative_to(ROOT)) for f in _PORT_FILES
                 if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_importing_the_port_leaves_jax_unloaded():
    mods = ["repro_torch", "repro_torch.core", "repro_torch.core.executor",
            "repro_torch.core.algorithms", "repro_torch.core.local",
            "repro_torch.core.engines.fused",
            "repro_torch.core.engines.sequential",
            "repro_torch.core.engines.batched", "repro_torch.core.state",
            "repro_torch.data",
            "repro_torch.data.store", "repro_torch.kernels.fused_sgd",
            "repro_torch.kernels.fused_sgd.kernel",
            "repro_torch.models.small", "repro_torch.configs.fedsr_mlp",
            "repro_torch.configs.fedsr_cnn", "repro_torch.checkpoint",
            "repro_torch.checkpoint.io", "repro_torch.core.personalize",
            "repro_torch.serve", "repro_torch.serve.fleet"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from repro_torch.core.algorithms import (\n"
            "    ALGORITHMS, Centralized, FedAvg, FedProx, HierFAVG, Moon,\n"
            "    RingOptimization, Scaffold)\n"
            "assert ALGORITHMS['fedavg'] is FedAvg\n"
            "assert ALGORITHMS['fedprox'] is FedProx\n"
            "assert ALGORITHMS['ring'] is RingOptimization\n"
            "assert ALGORITHMS['hieravg'] is HierFAVG\n"
            "assert ALGORITHMS['moon'] is Moon\n"
            "assert ALGORITHMS['scaffold'] is Scaffold\n"
            "assert ALGORITHMS['centralized'] is Centralized\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("override", [
    {"engine": "sharded"}, {"mesh_data_axis": "data"},
])
def test_unported_options_raise(monkeypatch, override):
    """What stays unported of the sharded engine and ``mesh_data_axis`` is
    a mesh over several distinct devices (ROADMAP A5.2): with two cards
    visible the run raises instead of shrinking the mesh."""
    import repro_torch.launch.mesh as mesh
    from repro_torch.core.executor import run_experiment

    _, (pm, pfl) = configs(SMALL, **_fl(**override))
    _, (ptr, pte) = _tasks(train_per_class=4, test_per_class=1)
    monkeypatch.setattr(mesh, "visible_devices", lambda device=None: [
        torch.device("cuda", 0), torch.device("cuda", 1)])
    with pytest.raises(NotImplementedError, match="ROADMAP A5.2"):
        run_experiment(task="mnist_like", model_cfg=pm, fl=pfl, train=ptr,
                       test=pte, device="cpu")


def test_entry_point_refuses_to_fall_back_to_the_cpu(monkeypatch):
    from repro_torch.core.executor import run_experiment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, (pm, pfl) = configs(SMALL, **_fl())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_experiment(task="mnist_like", model_cfg=pm, fl=pfl)
