"""The port's fused SGD update against the JAX package's.

On the CPU the port's wrapper runs its plain version (``ref.py``); it is
held against the Pallas kernel (``repro.kernels.fused_sgd.ops``, interpret
mode on the CPU) over the kernel's own test sweep, and — lane-stacked,
masked, with the visit-start reset — against the reference's per-step
update of ``_run_hops`` for both update paths (fused and unfused round
differently, ROADMAP C2, so each is held against its own). f32 with the
same elementwise order on both sides: rtol=1e-6, atol=1e-7.

The CUDA kernel itself runs only on the card:
``tests/test_torch_fused_sgd_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.fused_sgd.ops import fused_sgd_update
from repro_torch.kernels.fused_sgd.ops import FusedSGDLanes, fused_sgd_lanes

RTOL, ATOL = 1e-6, 1e-7


def _arrays(*shape, seed=0, count=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(count)]


def _port_step(p, g, m, ok, lr, *, reset, momentum, nesterov=False):
    tp, tm = torch.from_numpy(p.copy()), torch.from_numpy(m.copy())
    fused_sgd_lanes(tp, torch.from_numpy(g), tm, torch.from_numpy(ok),
                    torch.tensor([lr], dtype=torch.float32), reset=reset,
                    momentum=momentum, nesterov=nesterov)
    return tp.numpy(), tm.numpy()


# the sweep of the reference's own fused_sgd tests: odd tails (n, Pallas
# tile), zero momentum, Nesterov, and the paper MLP's 199,210 parameters
SWEEP = [
    (1, 256, 0.9, False), (255, 256, 0.9, False), (257, 256, 0.9, False),
    (1023, 1024, 0.9, False), (4097, 1024, 0.9, False),
    (199_210, 65_536, 0.9, False),
    (64, 64, 0.0, False),
    (300, 256, 0.5, True), (4097, 1024, 0.9, True),
]


@pytest.mark.parametrize("n,block,momentum,nesterov", SWEEP)
def test_plain_version_matches_pallas_kernel(n, block, momentum, nesterov):
    p, g, m = _arrays(n, seed=n)
    lr = 0.02
    pr, mr = fused_sgd_update(jnp.asarray(p), jnp.asarray(g), jnp.asarray(m),
                              lr=jnp.asarray(lr, jnp.float32),
                              momentum=momentum, nesterov=nesterov,
                              block=block)
    pp, mp = _port_step(p[None], g[None], m[None], np.ones(1, bool), lr,
                        reset=False, momentum=momentum, nesterov=nesterov)
    np.testing.assert_allclose(pp[0], np.asarray(pr), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mp[0], np.asarray(mr), rtol=RTOL, atol=ATOL)


def _ref_masked_step(use_fused_sgd, p, g, m, ok, lr, reset, momentum):
    """One step of the reference's ``_run_hops`` scan body on a (C, P)
    lane stack: the reset flag zeroes momentum, then the trainer's masked
    update (fused: Pallas + select; unfused: folded-mask arithmetic)."""
    from repro.configs.base import FLConfig
    from repro.configs.fedsr_mlp import CONFIG
    from repro.core.local import LocalTrainer

    trainer = LocalTrainer(CONFIG, FLConfig(momentum=momentum,
                                            use_fused_sgd=use_fused_sgd))
    update = trainer._many_spec["plain"][1]
    rs = jnp.float32(1.0 if reset else 0.0)
    mc = {"x": (1.0 - rs) * jnp.asarray(m)}
    pn, mn = update({"x": jnp.asarray(p)}, mc, {"x": jnp.asarray(g)},
                    jnp.asarray(lr, jnp.float32),
                    jnp.asarray(ok, jnp.float32))
    return np.asarray(pn["x"]), np.asarray(mn["x"])


@pytest.mark.parametrize("use_fused_sgd", [True, False])
@pytest.mark.parametrize("reset", [True, False])
def test_masked_lane_step_matches_reference_run_hops(use_fused_sgd, reset):
    C, P = 5, 1031
    p, g, m = _arrays(C, P, seed=3)
    ok = np.asarray([True, False, True, True, False])
    lr, momentum = 0.05, 0.5
    pr, mr = _ref_masked_step(use_fused_sgd, p, g, m, ok, lr, reset, momentum)
    if use_fused_sgd:
        pp, mp = _port_step(p, g, m, ok, lr, reset=reset, momentum=momentum)
    else:
        from repro_torch.core.local import masked_momentum_update
        tp, tm = torch.from_numpy(p.copy()), torch.from_numpy(m.copy())
        masked_momentum_update(tp, torch.from_numpy(g), tm,
                               torch.from_numpy(ok),
                               torch.tensor([lr], dtype=torch.float32),
                               reset=reset, momentum=momentum)
        pp, mp = tp.numpy(), tm.numpy()
    np.testing.assert_allclose(pp, pr, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mp, mr, rtol=RTOL, atol=ATOL)
    # lanes that take no step keep their parameters exactly
    np.testing.assert_array_equal(pp[~ok], p[~ok])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p, g, m = (torch.zeros(2, 8) for _ in range(3))
    ok, lr = torch.ones(2, dtype=torch.bool), torch.tensor([0.1])
    kw = {"reset": False, "momentum": 0.5}
    with pytest.raises(TypeError):
        fused_sgd_lanes(p.double(), g, m, ok, lr, **kw)
    with pytest.raises(TypeError):
        fused_sgd_lanes(p, g, m, ok.float(), lr, **kw)
    with pytest.raises(ValueError):
        fused_sgd_lanes(p, g[:, :4], m, ok, lr, **kw)
    with pytest.raises(ValueError):
        fused_sgd_lanes(p, g, m, ok[:1], lr, **kw)
    with pytest.raises(ValueError):
        fused_sgd_lanes(torch.zeros(8, 2).t(), g, m, ok, lr, **kw)
    with pytest.raises(ValueError):
        fused_sgd_lanes(p, g, m, ok, torch.tensor([0.1, 0.2]), **kw)


def test_cpu_path_counts_no_launch():
    wrapper = FusedSGDLanes()
    p, g, m = (torch.ones(3, 16) for _ in range(3))
    wrapper(p, g, m, torch.ones(3, dtype=torch.bool), torch.tensor([0.5]),
            reset=True, momentum=0.5)
    assert wrapper.launches == 0
    torch.testing.assert_close(p, torch.full((3, 16), 0.5))
