"""The port's ``core/ring.py::ring_optimization`` (Algorithm 1's inner loop
as written: the model hops client to client through
``LocalTrainer.train``) against the JAX package's.

* The twins of ``tests/test_fl_core.py``'s ring checks: the loop is the
  sequential chain of client visits, and more laps move the model further.
* Against the reference from the same numpy ``w0`` and the same
  ``np.random.default_rng`` seed, on the narrow MLP over 4 clients at laps
  1 and 3, momentum 0 and 0.9: every visit's batch plan exact and the
  generator in the same state after; the final weights within 1e-5 (one
  visit is held at 1e-5 in ``tests/test_torch_engines.py``; a whole chain
  here agrees at float32 rounding); the ``p2p`` meter equal to the
  reference's and to ``ring_lap_hops``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from torch_parity import SMALL, assert_trees_close, configs, jax_init

CPU = torch.device("cpu")
RING_TOL = 1e-5


def _clients(n=4, seed=0):
    """Both packages' ``mnist_like`` clients at a small size, iid."""
    from repro.data.pipeline import make_clients as ref_make_clients
    from repro.data.synthetic import make_task as ref_make_task
    from repro_torch.data.pipeline import make_clients
    from repro_torch.data.synthetic import make_task

    kw = dict(train_per_class=12, test_per_class=4, seed=seed)
    (rtrain, _), (ptrain, _) = (ref_make_task("mnist_like", **kw),
                                make_task("mnist_like", **kw))
    return (ref_make_clients(rtrain, scheme="iid", num_devices=n,
                             rng=np.random.default_rng(seed)),
            make_clients(ptrain, scheme="iid", num_devices=n,
                         rng=np.random.default_rng(seed)))


def _trainers(momentum):
    from repro.core.local import LocalTrainer as RefTrainer
    from repro_torch.core.local import LocalTrainer

    (rm, rfl), (pm, pfl) = configs(SMALL, num_devices=4, num_edges=1,
                                   batch_size=8, momentum=momentum)
    return RefTrainer(rm, rfl), LocalTrainer(pm, pfl, CPU), rm


def _flat(w0):
    from repro_torch.models.small import params_from_numpy
    from repro_torch.utils.tree import ravel_params

    return ravel_params(params_from_numpy(w0, CPU))


def _record(monkeypatch, module):
    """Record every plan ``module``'s ``LocalTrainer.train`` draws."""
    import importlib

    mod = importlib.import_module(module)
    seen, orig = [], mod.plan_epoch_indices

    def plan_epoch_indices(*a, **k):
        plan = orig(*a, **k)
        seen.append(np.array(plan))
        return plan

    monkeypatch.setattr(mod, "plan_epoch_indices", plan_epoch_indices)
    return seen


def test_ring_optimization_is_sequential_incremental():
    """Alg. 1's inner loop == the manual chain of client visits."""
    from repro_torch.core import ring_optimization

    _, tr, rm = _trainers(0.0)
    _, clients = _clients()
    w0 = _flat(jax_init(rm))
    w_ring = ring_optimization(tr, w0, clients, lr=0.05, laps=1,
                               local_epochs=1, rng=np.random.default_rng(7))
    rng = np.random.default_rng(7)
    w = w0
    for c in clients:
        w = tr.train(w, c, lr=0.05, epochs=1, rng=rng)
    diff = float(torch.linalg.vector_norm(w_ring - w))
    assert diff < 1e-6, diff


def test_ring_laps_multiply_updates():
    from repro_torch.core import ring_optimization

    _, tr, rm = _trainers(0.0)
    _, clients = _clients(2)
    w0 = _flat(jax_init(rm))
    before = w0.clone()
    w1, w3 = (ring_optimization(tr, w0, clients, lr=0.05, laps=laps,
                                local_epochs=1, rng=np.random.default_rng(0))
              for laps in (1, 3))
    assert torch.equal(w0, before)          # the caller's model is kept
    assert float(torch.linalg.vector_norm(w3 - w0)) > float(
        torch.linalg.vector_norm(w1 - w0))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("laps", [1, 3])
def test_ring_optimization_matches_the_reference(monkeypatch, laps, momentum):
    from repro.core.comm import CommMeter as RefMeter
    from repro.core.ring import ring_optimization as ref_ring
    from repro_torch.core.comm import CommMeter
    from repro_torch.core.ring import ring_lap_hops, ring_optimization
    from repro_torch.utils.tree import unravel

    ref_tr, tr, rm = _trainers(momentum)
    rclients, pclients = _clients()
    w0 = jax_init(rm, seed=3)
    ref_plans = _record(monkeypatch, "repro.core.local")
    port_plans = _record(monkeypatch, "repro_torch.core.local")
    rr, pr = np.random.default_rng(11), np.random.default_rng(11)
    rmeter, pmeter = RefMeter(), CommMeter()
    want = ref_ring(ref_tr, jax.tree.map(jnp.asarray, w0), rclients, lr=0.05,
                    laps=laps, local_epochs=1, rng=rr, meter=rmeter)
    got = ring_optimization(tr, _flat(w0), pclients, lr=0.05, laps=laps,
                            local_epochs=1, rng=pr, meter=pmeter)
    assert len(port_plans) == len(ref_plans) == laps * len(pclients)
    for a, b in zip(ref_plans, port_plans):
        np.testing.assert_array_equal(a, b)
    assert rr.bit_generator.state == pr.bit_generator.state
    assert_trees_close(unravel(got, tr.layout), want, atol=RING_TOL)
    assert dataclasses.asdict(pmeter) == dataclasses.asdict(rmeter)
    assert pmeter.p2p == rmeter.p2p == ring_lap_hops(len(pclients), laps)
    assert pmeter.total_transfers == pmeter.p2p
    assert tr.dispatches == ref_tr.dispatches > 0


def test_one_client_ring_records_no_hops():
    from repro_torch.core.comm import CommMeter
    from repro_torch.core.ring import ring_lap_hops, ring_optimization

    _, tr, rm = _trainers(0.0)
    _, clients = _clients()
    meter = CommMeter()
    ring_optimization(tr, _flat(jax_init(rm)), clients[:1], lr=0.05, laps=3,
                      local_epochs=1, rng=np.random.default_rng(0),
                      meter=meter)
    assert meter.p2p == ring_lap_hops(1, 3) == 0


def test_the_ring_loop_is_exported_like_the_reference():
    import repro.core as ref_core
    import repro_torch.core as core

    assert "ring_optimization" in core.__all__
    assert sorted(core.__all__) == sorted(ref_core.__all__)
