"""The port's privacy ledger (``core/privacy.py``) against the JAX
package's: closed-form host math, so every readout is held with ``==``.

* ``ORDERS`` and ``rdp_per_step`` at every noise multiplier and sampling
  rate (q = 1, q < 1, and noise 0, infinitely leaky at every order).
* ``PrivacyLedger``: epsilon after a sequence of records, at each order
  on its own and over the whole grid, ``spent``, zero steps, and the
  rejected arguments.
* ``plan_max_client_steps`` on the reference's own plans (the port's
  function on the reference's ``RoundPlan``s, and the port's plans from
  the same seed), for every planned algorithm, plain, under drops, and
  under train-slow truncation.
"""
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.core.privacy import ORDERS  # noqa: E402
from torch_parity import configs, mnist_tasks  # noqa: E402

NOISES = (0.0, 0.3, 1.1, 4.0)
RATES = (1.0, 0.25, 0.01)


def _pkgs():
    import repro.core.privacy as ref
    import repro_torch.core.privacy as port

    return ref, port


def test_orders_are_the_reference():
    ref, port = _pkgs()
    assert port.ORDERS == ref.ORDERS
    assert all(a > 1 for a in port.ORDERS)


@pytest.mark.parametrize("q", RATES)
@pytest.mark.parametrize("noise", NOISES)
def test_rdp_per_step_is_the_reference(noise, q):
    ref, port = _pkgs()
    got = port.rdp_per_step(noise, q)
    assert got == ref.rdp_per_step(noise, q)
    assert len(got) == len(port.ORDERS)
    if noise == 0:
        assert all(r == math.inf for r in got)
    else:
        # the sampled bound never exceeds the full-batch mechanism's
        assert all(r <= a / (2 * noise * noise) for a, r in
                   zip(port.ORDERS, got))


_ORDER_CASES = [(a, q) for a in ORDERS for q in (1.0, 0.1)]


@pytest.mark.parametrize("order,q", _ORDER_CASES)
def test_each_order_alone_is_the_reference(order, q):
    """A grid of one order: the ledger's epsilon is that order's
    conversion, the same float in both packages."""
    ref, port = _pkgs()
    a = port.PrivacyLedger(1.1, 1e-5, q, orders=(order,))
    b = ref.PrivacyLedger(1.1, 1e-5, q, orders=(order,))
    for steps in (1, 40, 0, 959):
        a.record(steps)
        b.record(steps)
        assert a.epsilon() == b.epsilon()
    assert a.steps == b.steps == 1000
    rdp = port.rdp_per_step(1.1, q, (order,))[0]
    assert a.epsilon() == 1000 * rdp + math.log(1e5) / (order - 1.0)


@pytest.mark.parametrize("delta", (1e-5, 1e-3, 0.5))
@pytest.mark.parametrize("q", RATES)
@pytest.mark.parametrize("noise", NOISES)
def test_ledger_is_the_reference(noise, q, delta):
    ref, port = _pkgs()
    a = port.PrivacyLedger(noise, delta, q)
    b = ref.PrivacyLedger(noise, delta, q)
    assert a.epsilon() == b.epsilon() == 0.0
    for steps in (3, 0, 120, 7):
        a.record(steps)
        b.record(steps)
        assert a.spent == b.spent
    assert a.steps == 130 and a.delta == delta
    if noise == 0:
        assert a.epsilon() == math.inf
    else:
        assert 0 < a.epsilon() < math.inf


@pytest.mark.parametrize("make", [
    lambda pkg: pkg.PrivacyLedger(1.0, 0.0),
    lambda pkg: pkg.PrivacyLedger(1.0, 1.0),
    lambda pkg: pkg.PrivacyLedger(1.0).record(-1)])
def test_ledger_rejects_what_the_reference_rejects(make):
    for pkg in _pkgs():
        with pytest.raises(ValueError):
            make(pkg)


SCENARIOS = {"plain": {}, "drop": {"drop_rate": 0.5, "seed": 4},
             "slow": {"train_slow_frac": 0.5, "slow_step_factor": 0.5,
                      "seed": 2}}
ALGOS = ("fedavg", "fedprox", "moon", "scaffold", "fedsr", "ring", "hieravg")


def _per_client(plan) -> dict:
    """Each client's steps in one plan, counted plan by plan."""
    out = {}
    for g in plan.groups:
        for h in g.hops:
            for i, p in zip(h.ids, h.plans):
                if p is not None:
                    out[i] = out.get(i, 0) + len(p)
    return out


def _planners(algo, scenario):
    """The ``algo`` planner of each package over identical clients, under
    the scenario ``SCENARIOS[scenario]`` and DP-SGD."""
    from repro.core.algorithms import make_algorithm as ref_make
    from repro.core.local import LocalTrainer as RefTrainer
    from repro.data.pipeline import make_clients as ref_clients
    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.core.local import LocalTrainer
    from repro_torch.data.pipeline import make_clients

    (rm, rfl), (pm, pfl) = configs(
        {"mlp_hidden": (8,)}, algorithm=algo, engine="fused", num_devices=8,
        num_edges=2, ring_rounds=2, batch_size=4, participation=0.75,
        dp_clip=1.0, dp_noise_mult=1.1, scenario=SCENARIOS[scenario])
    (rtr, _), (ptr, _) = mnist_tasks(train_per_class=6, test_per_class=1)
    rp = ref_make(algo, RefTrainer(rm, rfl), ref_clients(
        rtr, scheme="dirichlet", num_devices=8,
        rng=np.random.default_rng(0), alpha=0.5), rfl)
    pp = make_algorithm(algo, LocalTrainer(pm, pfl, "cpu"), make_clients(
        ptr, scheme="dirichlet", num_devices=8,
        rng=np.random.default_rng(0), alpha=0.5), pfl)
    return rp, pp


def _visits(sched):
    return [p for plan in sched.plans for g in plan.groups for h in g.hops
            for p in h.plans]


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("algo", ALGOS)
def test_plan_max_client_steps_on_the_reference_plans(algo, scenario):
    """The reference's plans of three rounds (and the port's from the
    same seed): each plan's worst-case client steps the same in both
    packages, and the largest per-client count; a dropped visit costs
    nothing and a train-slow visit charges its truncated steps, so neither
    charges more than the plain plans do."""
    ref, port = _pkgs()
    rp, pp = _planners(algo, scenario)
    rs = rp.plan_schedule(0, 3, np.random.default_rng(5), {})
    ps = pp.plan_schedule(0, 3, np.random.default_rng(5), {})
    got = [port.plan_max_client_steps(p) for p in rs.plans]
    assert got == [ref.plan_max_client_steps(p) for p in rs.plans]
    assert got == [port.plan_max_client_steps(p) for p in ps.plans]
    assert got == [max(_per_client(p).values(), default=0)
                   for p in rs.plans]
    assert all(n > 0 for n in got)
    if scenario != "plain":
        plain = _planners(algo, "plain")[0].plan_schedule(
            0, 3, np.random.default_rng(5), {})
        # the drop draws follow each round's plan, so only round 1 was
        # planned from the same stream as the plain round
        n = 1 if scenario == "drop" else 3
        assert all(a <= b for a, b in zip(
            got[:n], map(ref.plan_max_client_steps, plain.plans[:n])))
        if scenario == "drop":
            assert any(p is None for p in _visits(rs))
        else:
            assert any(a is not None and len(a) < len(b) for a, b in
                       zip(_visits(rs), _visits(plain)))
    # the ledger charges these counts block by block
    pp.finish_block(ps, {}, None)
    assert pp.privacy.steps == sum(got)


def test_plan_without_groups_costs_nothing():
    _, port = _pkgs()
    from repro_torch.core.plan import RoundPlan

    assert port.plan_max_client_steps(RoundPlan(groups=(), comm=())) == 0


def test_the_ledger_is_the_ports_own_copy():
    """``core/privacy.py`` lives in the port and imports neither JAX nor
    the reference (in a fresh interpreter)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "import repro_torch.core.privacy as p\n"
            "print(p.__file__)\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    path, loaded = out.stdout.strip().splitlines()
    assert Path(path) == root / "src" / "repro_torch" / "core" / "privacy.py"
    assert loaded == "[]"
