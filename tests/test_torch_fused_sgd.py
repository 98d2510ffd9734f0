"""The port's fused SGD update against the JAX package's.

On the CPU the port's wrapper runs its plain version (``ref.py``); it is
held against the Pallas kernel (``repro.kernels.fused_sgd.ops``, interpret
mode on the CPU) over the kernel's own test sweep, and — lane-stacked,
masked, with the visit-start reset — against the reference's per-step
update of ``_run_hops`` for both update paths (fused and unfused round
differently, ROADMAP C2, so each is held against its own). f32 with the
same elementwise order on both sides: rtol=1e-6, atol=1e-7.

The gradient may be a list of leaves, read in place by the kernel: the
leaf-list wrapper is held against the Pallas kernel on each lane's raveled
leaves (``ravel_pytree``) — a narrow MLP's six leaves, odd sizes, and the
full-width paper CNN's ten — and a narrow fused FedSR run with autograd's
leaves ends bit for bit where the same run with a one-leaf (C, P) gradient
does. The CNN trainer hands the wrapper leaves it takes: autograd returns
the conv weights' gradients as strided views, which the wrapper refuses,
and ``lane_grads`` makes them dense.

In bfloat16 (the reference's kernel at ``p.dtype = bfloat16``, as its LM
step runs it with bfloat16 parameters) the plain version rounds to
bfloat16 after every operation, with mu rounded to bfloat16 and lr read
at bfloat16, as the reference does; it is held against the Pallas kernel
bit for bit, with mu 0.5 and 0.9, Nesterov on and off, over sizes that
are not multiples of its 65,536-wide block, and as a leaf list. The
wrapper refuses a mixed set of dtypes.

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


def _bf16(x):
    """numpy float32 -> (the jnp bfloat16 array, the same bits in torch)."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("n", [1, 257, 65_535, 200_003])
@pytest.mark.parametrize("momentum", [0.5, 0.9])
@pytest.mark.parametrize("nesterov", [False, True])
def test_bf16_plain_version_is_the_pallas_kernel_bit_for_bit(n, momentum,
                                                             nesterov):
    p, g, m = _arrays(n, seed=n + 1)
    (jp, tp), (jg, tg), (jm, tm) = _bf16(p), _bf16(g), _bf16(m)
    lr = jnp.asarray(0.3, jnp.float32).astype(jnp.bfloat16)   # 0.30078125
    pr, mr = fused_sgd_update(jp, jg, jm, lr=lr, momentum=momentum,
                              nesterov=nesterov)
    tp, tm = tp[None].clone(), tm[None].clone()
    fused_sgd_lanes(tp, tg[None], tm, torch.ones(1, dtype=torch.bool),
                    torch.tensor([0.3]).bfloat16(), reset=False,
                    momentum=momentum, nesterov=nesterov)
    assert tp.dtype == tm.dtype == torch.bfloat16
    np.testing.assert_array_equal(tp[0].float().numpy(),
                                  np.asarray(pr.astype(jnp.float32)))
    np.testing.assert_array_equal(tm[0].float().numpy(),
                                  np.asarray(mr.astype(jnp.float32)))


def test_bf16_rounds_every_operation_as_the_reference():
    """The rounding the bit-equality rests on: computing in float32 and
    rounding once, or keeping mu = 0.9 in float32 (as a Python float
    times a bfloat16 tensor does in PyTorch), gives other bits on many
    elements."""
    p, g, m = _arrays(20_000, seed=5)
    (_, tp), (_, tg), (_, tm) = _bf16(p), _bf16(g), _bf16(m)
    lr = torch.tensor([0.3]).bfloat16()
    pk, mk = tp[None].clone(), tm[None].clone()
    fused_sgd_lanes(pk, tg[None], mk, torch.ones(1, dtype=torch.bool), lr,
                    reset=False, momentum=0.9)
    m_once = (0.9 * tm.float() + tg.float()).bfloat16()
    p_once = (tp.float() - lr.float() * m_once.float()).bfloat16()
    assert (m_once != mk[0]).sum() > 1000
    assert (p_once != pk[0]).sum() > 10
    m_mu32 = ((0.9 * tm.float()).bfloat16().float() + tg.float()).bfloat16()
    assert (m_mu32 != mk[0]).sum() > 1000


@pytest.mark.parametrize("reset", [False, True])
def test_bf16_leaf_list_is_the_pallas_kernel_on_raveled_leaves(reset):
    """The narrow MLP's six leaves over C = 3 lanes, one of which takes no
    step, in bfloat16: each stepping lane bit for bit the Pallas kernel
    on its raveled leaves (momentum zeroed first under ``reset``)."""
    shapes = LAYOUTS["narrow_mlp"]
    C = 3
    p, leaves, m = _leaf_arrays(C, shapes, seed=11)
    ok = np.asarray([True, False, True])
    (jp, tp), (jm, tm) = _bf16(p), _bf16(m)
    tleaves = [_bf16(x)[1] for x in leaves]
    lr = jnp.asarray(0.05, jnp.float32).astype(jnp.bfloat16)
    pk, mk = tp.clone(), tm.clone()
    fused_sgd_lanes(pk, tleaves, mk, torch.from_numpy(ok),
                    torch.tensor([0.05]).bfloat16(), reset=reset,
                    momentum=0.9)
    for c in range(C):
        m_in = jnp.zeros_like(jm[c]) if reset else jm[c]
        if not ok[c]:
            np.testing.assert_array_equal(pk[c].float().numpy(),
                                          tp[c].float().numpy())
            np.testing.assert_array_equal(
                mk[c].float().numpy(), np.asarray(m_in.astype(jnp.float32)))
            continue
        g = jnp.concatenate([jnp.asarray(x[c].reshape(-1), jnp.bfloat16)
                             for x in leaves])
        pr, mr = fused_sgd_update(jp[c], g, m_in, lr=lr, momentum=0.9)
        np.testing.assert_array_equal(pk[c].float().numpy(),
                                      np.asarray(pr.astype(jnp.float32)))
        np.testing.assert_array_equal(mk[c].float().numpy(),
                                      np.asarray(mr.astype(jnp.float32)))


def test_wrapper_refuses_mixed_dtypes():
    p, g, m = (torch.zeros(2, 8, dtype=torch.bfloat16) for _ in range(3))
    ok = torch.ones(2, dtype=torch.bool)
    lr = torch.tensor([0.1]).bfloat16()
    kw = {"reset": False, "momentum": 0.5}
    for args in ((p, g.float(), m, ok, lr), (p, g, m.float(), ok, lr),
                 (p, g, m, ok, lr.float()), (p.float(), g, m, ok, lr),
                 (p.half(), g.half(), m.half(), ok, lr.half())):
        with pytest.raises(TypeError):
            fused_sgd_lanes(*args, **kw)
    fused_sgd_lanes(p, [g[:, :3].contiguous(), g[:, 3:].contiguous()], m, ok,
                    lr, **kw)


def test_cpu_path_counts_no_launch():
    wrapper = FusedSGDLanes()
    p, g, m = (torch.ones(3, 16) for _ in range(3))
    wrapper(p, g, m, torch.ones(3, dtype=torch.bool), torch.tensor([0.5]),
            reset=True, momentum=0.5)
    assert wrapper.launches == 0
    torch.testing.assert_close(p, torch.full((3, 16), 0.5))


# ---------------------------------------------------------------------------
# the gradient as a list of leaves, read in place


def _narrow_mlp_layout():
    """The port's sorted-leaf layout of a narrow paper MLP (8x8 images,
    hidden (12, 6), 10 classes): b0, b1, b2 (the 10-element leaf), w0, w1,
    w2."""
    import dataclasses

    from repro_torch.configs.fedsr_mlp import CONFIG
    from repro_torch.models.small import mlp_specs

    cfg = dataclasses.replace(CONFIG, image_size=8, mlp_hidden=(12, 6))
    specs = mlp_specs(cfg)
    return [tuple(specs[k].shape) for k in sorted(specs)]


def _cnn_layout():
    """The full-width paper CNN's sorted-leaf layout: ten leaves, 319,178
    parameters, ``fc1_b`` of 10 floats."""
    from repro_torch.configs.fedsr_cnn import CONFIG
    from repro_torch.models.small import cnn_specs

    specs = cnn_specs(CONFIG)
    return [tuple(specs[k].shape) for k in sorted(specs)]


LAYOUTS = {
    "cnn": _cnn_layout(),
    "narrow_mlp": _narrow_mlp_layout(),
    # odd sizes at odd offsets: every leaf but the first off p's 16-byte grid
    "odd": [(3,), (1,), (7, 5), (2,), (13,), (1,), (33,)],
}


def _leaf_arrays(C, shapes, seed):
    rng = np.random.default_rng(seed)
    P = sum(int(np.prod(s)) for s in shapes)
    p, m = (rng.standard_normal((C, P)).astype(np.float32) for _ in range(2))
    leaves = [rng.standard_normal((C, *s)).astype(np.float32) for s in shapes]
    return p, leaves, m


def _ref_raveled_step(p, leaves, m, ok, lr, *, reset, momentum, nesterov,
                      block=256):
    """The JAX package's fused_sgd_update on each lane's raveled leaves
    (``ravel_pytree`` of the lane's leaf dict, the reference's own flat
    gradient), then the reference trainer's per-lane select: lanes that do
    not step keep p and take the (reset) momentum."""
    from jax.flatten_util import ravel_pytree

    names = [f"leaf{k:02d}" for k in range(len(leaves))]   # sorted = list order
    p_out, m_out = p.copy(), m.copy()
    for c in range(p.shape[0]):
        g_c, _ = ravel_pytree({n: jnp.asarray(x[c])
                               for n, x in zip(names, leaves)})
        m_in = np.zeros_like(m[c]) if reset else m[c]
        if ok[c]:
            pr, mr = fused_sgd_update(
                jnp.asarray(p[c]), g_c, jnp.asarray(m_in),
                lr=jnp.asarray(lr, jnp.float32), momentum=momentum,
                nesterov=nesterov, block=block)
            p_out[c], m_out[c] = np.asarray(pr), np.asarray(mr)
        else:
            m_out[c] = m_in
    return p_out, m_out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("reset", [False, True])
@pytest.mark.parametrize("ok_mask,nesterov", [
    ((True, True, True), False),
    ((True, False, True), False),
    ((False, False, False), False),
    ((True, False, True), True),
])
def test_leaf_list_matches_pallas_kernel_on_raveled_leaves(layout, reset,
                                                           ok_mask, nesterov):
    shapes = LAYOUTS[layout]
    C = len(ok_mask)
    p, leaves, m = _leaf_arrays(C, shapes, seed=len(shapes))
    ok = np.asarray(ok_mask)
    lr, momentum = 0.05, 0.9
    atol, block = ATOL, 256
    if layout == "cnn":
        # The Pallas kernel in interpret mode takes ~0.5 s a call at 256-wide
        # blocks over 319,178 parameters; its 65,536-wide block (the
        # reference's default) computes the same elementwise update. XLA
        # contracts mu*m + g and p - lr*d into fused multiply-adds on the
        # CPU where the plain version rounds each product, so results that
        # cancel to near zero differ by up to an ulp of the operands: over
        # these 957,534 elements that shows beyond the 1e-7 atol of the
        # narrow layouts, so this layout's atol is two ulps of its largest
        # |p|.
        atol, block = 2 * float(np.spacing(np.abs(p).max())), 65_536
    pr, mr = _ref_raveled_step(p, leaves, m, ok, lr, reset=reset,
                               momentum=momentum, nesterov=nesterov,
                               block=block)
    tp, tm = torch.from_numpy(p.copy()), torch.from_numpy(m.copy())
    fused_sgd_lanes(tp, [torch.from_numpy(x) for x in leaves], tm,
                    torch.from_numpy(ok), torch.tensor([lr]), reset=reset,
                    momentum=momentum, nesterov=nesterov)
    np.testing.assert_allclose(tp.numpy(), pr, rtol=RTOL, atol=atol)
    np.testing.assert_allclose(tm.numpy(), mr, rtol=RTOL, atol=atol)
    np.testing.assert_array_equal(tp.numpy()[~ok], p[~ok])


def _rejected_leaf_lists():
    C, P = 2, 12
    return {
        "non_contiguous_leaf": [torch.zeros(6, C).t(), torch.zeros(C, 6)],
        "wrong_lane_count": [torch.zeros(C + 1, 6), torch.zeros(C, 6)],
        "sizes_not_summing_to_P": [torch.zeros(C, 6), torch.zeros(C, 5)],
        "more_than_16_leaves": [torch.zeros(C, 1) for _ in range(P)]
        + [torch.zeros(C, 0) for _ in range(5)],
    }


@pytest.mark.parametrize("case", sorted(_rejected_leaf_lists()))
def test_wrapper_rejects_leaf_lists_the_kernel_does_not_take(case):
    grads = _rejected_leaf_lists()[case]
    p, m = torch.zeros(2, 12), torch.zeros(2, 12)
    with pytest.raises(ValueError):
        fused_sgd_lanes(p, grads, m, torch.ones(2, dtype=torch.bool),
                        torch.tensor([0.1]), reset=False, momentum=0.5)
    # the caller's buffers are untouched: nothing was concatenated or stepped
    assert not p.any() and not m.any()


def test_cnn_lane_grads_are_leaves_the_wrapper_reads_in_place():
    """Autograd returns each conv weight's gradient as a permuted view of
    the grouped conv's (C*Cout, Cin, 3, 3) gradient: the wrapper refuses
    it (it never falls back to a copy of its own), and ``lane_grads``
    hands it ten dense leaves, in layout order, that it takes."""
    import dataclasses

    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.fedsr_cnn import CONFIG
    from repro_torch.core.local import LocalTrainer
    from repro_torch.models.small import (
        classifier_loss_lanes, init_small_model,
    )
    from repro_torch.utils.tree import ravel_params, unravel

    cfg = dataclasses.replace(CONFIG, image_size=8)
    trainer = LocalTrainer(cfg, FLConfig(momentum=0.9), torch.device("cpu"))
    C = 3
    flat = torch.stack([ravel_params(init_small_model(
        torch.Generator().manual_seed(c), cfg, torch.device("cpu")))
        for c in range(C)])
    gen = torch.Generator().manual_seed(0)
    batch = {"images": torch.rand(C, 4, 8, 8, 3, generator=gen),
             "labels": torch.randint(0, 10, (C, 4), generator=gen)}
    ok, lr = torch.ones(C, dtype=torch.bool), torch.tensor([0.1])

    leaves = {k: v.detach().requires_grad_()
              for k, v in unravel(flat, trainer.layout).items()}
    names = [k for k, _ in trainer.layout]
    with torch.enable_grad():
        raw = torch.autograd.grad(
            classifier_loss_lanes(leaves, batch, cfg).sum(),
            [leaves[k] for k in names])
    strided = sorted(k for k, g in zip(names, raw) if not g.is_contiguous())
    assert strided == ["conv0_w", "conv1_w", "conv2_w"]
    m = torch.zeros_like(flat)
    with pytest.raises(ValueError, match="contiguous"):
        fused_sgd_lanes(flat.clone(), list(raw), m, ok, lr, reset=True,
                        momentum=0.9)

    _, grads = trainer.lane_grads(flat, batch)
    assert [tuple(g.shape) for g in grads] == [
        (C, *shape) for _, shape in trainer.layout]
    assert all(g.is_contiguous() for g in grads)
    for a, b in zip(grads, raw):
        assert torch.equal(a, b)
    p = flat.clone()
    fused_sgd_lanes(p, grads, m, ok, lr, reset=True, momentum=0.9)
    g = torch.cat([x.reshape(C, -1) for x in grads], dim=1)
    torch.testing.assert_close(p, flat - 0.1 * g, rtol=RTOL, atol=ATOL)


def test_stack_of_more_than_65535_lanes_is_accepted():
    C, P = 65_536, 4
    p, g, m = _arrays(C, P, seed=7)
    ok = np.arange(C) % 3 != 0
    tp, tm = torch.from_numpy(p.copy()), torch.from_numpy(m.copy())
    fused_sgd_lanes(tp, [torch.from_numpy(g[:, :1].copy()),
                         torch.from_numpy(g[:, 1:].copy())], tm,
                    torch.from_numpy(ok), torch.tensor([0.1]), reset=False,
                    momentum=0.9)
    keep = ok[:, None]
    m_new = np.float32(0.9) * m + g
    np.testing.assert_allclose(tm.numpy(), np.where(keep, m_new, m),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tp.numpy(), np.where(keep, p - np.float32(0.1) * m_new, p),
        rtol=RTOL, atol=ATOL)


def test_fused_run_reads_leaves_as_the_one_leaf_run_reads_its_gradient(
        monkeypatch):
    """A narrow fused FedSR run with the gradient as autograd's leaves
    ends on the same weights, bit for bit, as the same run whose gradient
    is one (C, P) tensor taken with respect to the flat lane stack itself
    (so independent of the leaf order)."""
    import dataclasses

    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.fedsr_mlp import CONFIG
    from repro_torch.core.executor import run_experiment
    from repro_torch.core.local import LocalTrainer
    from repro_torch.data.synthetic import make_task
    from repro_torch.models.small import (
        classifier_loss_lanes, init_small_model, params_to_numpy,
    )
    from repro_torch.utils.tree import unravel

    cfg = dataclasses.replace(CONFIG, mlp_hidden=(16, 8))
    fl = FLConfig(algorithm="fedsr", engine="fused", num_devices=4,
                  num_edges=2, ring_rounds=2, rounds=2, batch_size=8,
                  partition="pathological", use_fused_sgd=True)
    init = params_to_numpy(init_small_model(torch.Generator().manual_seed(0),
                                            cfg, torch.device("cpu")))

    def run():
        train, test = make_task("mnist_like", train_per_class=10,
                                test_per_class=5)
        return run_experiment(task="mnist_like", model_cfg=cfg, fl=fl,
                              eval_every=2, train=train, test=test,
                              init_params=init, device="cpu").final_model

    leaves_run = run()

    def flat_lane_grads(self, params, batch, anchor=None):
        assert anchor is None       # FedSR trains the plain loss
        flat = params.detach().requires_grad_()
        with torch.enable_grad():
            losses = classifier_loss_lanes(unravel(flat, self.layout), batch,
                                           self.cfg)
            (g,) = torch.autograd.grad(losses.sum(), [flat])
        return losses.detach(), g

    monkeypatch.setattr(LocalTrainer, "lane_grads", flat_lane_grads)
    one_leaf_run = run()
    assert sorted(leaves_run) == sorted(one_leaf_run)
    for k in leaves_run:
        assert torch.equal(leaves_run[k], one_leaf_run[k]), k
