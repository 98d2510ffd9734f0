"""The port's LM training path (``launch/train.py``, ``launch/steps.py``,
``optim/``, ``lm_loss``) against the JAX package's, on the CPU.

* Exactly: ``make_token_stream`` and ``ClientTokenStore``'s batches,
  ``_host_mesh_shape``, ``MetricLogger``'s records but their ``t``.
* Within stated tolerances (float32 on both sides, summed in other
  orders):
  - the schedules, ``SGD`` (plain, nesterov, weight decay, ``fused=True``
    on the CPU, which runs the kernel's plain version) and ``AdamW`` over
    3 updates: 1e-6 relative;
  - ``lm_loss`` and its gradient against ``jax.grad``, with and without a
    mask: 1e-5 of the largest |value| (measured up to 1e-6);
  - ``make_train_step`` at C = 3 lanes against the reference's step built
    on ``make_host_mesh()`` (its vmaps and roll read only the state's
    leading axis), with ``hop_momentum``, ``fused_sgd`` and ``remat`` on
    and off: loss, params and momentum after steps 1, 2, 3 and after
    ``cloud_sync``. Each update form against its own reference form
    (ROADMAP C2): fused against the Pallas kernel (interpret mode), unfused
    against the jnp update. Measured: losses within 9.5e-7, params within
    2.4e-7 (one ulp of the largest |p|, 2.79), momentum within 5.3e-7;
    held at ``LOSS_TOL``, ``PARAM_TOL`` (four ulps) and ``MOM_TOL``;
  - serial mode against the reference at C = 1, and against a manual chain
    of the port's own steps at C = 4 (the reference's
    ``tests/test_serial_ring.py`` check);
  - ``train_loop`` at C = 1 against the reference's from the same numpy
    initial weights, 10 steps at lr 0.3 with a cloud sync every 5: the
    ``MetricLogger`` records' losses and the returned first and final
    losses within ``LOOP_TOL``.

The parity states start from the reference's initial weights with ``wq``
and ``wk`` scaled by 0.1. At the reference's own scale (``fan_in`` reads
``shape[-2]``, the head count) this tiny config's attention scores have a
std near 180, most softmax rows are one-hot and near-ties amplify
rounding (ROADMAP C12): a relative 1e-7 change of the weights moves the
reference's own gradient by up to 7.8e-5 of each leaf's largest value,
against 8.3e-7 with the scaling (``scripts/lm_grad_gap.py --reference``).
Scaled, the scores are O(1) and the two packages' steps agree at float32
rounding, so a real fault would show.
``train_loop`` starts both packages from those weights too (the
reference's loop is handed them in place of its own draw).

* The port's rules: C11 (the LM step ignores ``optimizer``,
  ``weight_decay``, ``compute_dtype``, ``dp_clip``, ``dp_noise_mult``, in
  both packages), what raises, and that ``repro_torch.launch.train``
  imports nothing of JAX or of the JAX package.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import torch_parity  # noqa: F401  (one torch thread in each test worker)

from repro.configs.base import TrainConfig as RefTrainConfig
from repro.launch import mesh as ref_mesh
from repro.launch import steps as ref_steps
from repro.launch import train as ref_train
from repro.models import transformer as RT
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import steps as port_steps
from repro_torch.launch import train as port_train
from repro_torch.models import transformer as PT
from repro_torch.utils.tree import flatten_tree

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
LOSS_TOL, PARAM_TOL, MOM_TOL = 5e-6, 1e-6, 2e-6
LOOP_TOL = 1e-4
TINY = dict(num_layers=2, d_model=64, d_ff=128, num_heads=2,
            num_kv_heads=2, vocab_size=128, name="train-test")


def _cfgs():
    return (dataclasses.replace(ref_train.lm_100m_config(), **TINY),
            dataclasses.replace(port_train.lm_100m_config(), **TINY))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _weights(ref_cfg, seed=0, qk_scale=0.1):
    """The reference's initial weights as numpy, wq and wk scaled."""
    base = _np(RT.init_model(jax.random.PRNGKey(seed), ref_cfg))
    attn = base["blocks"]["pos0"]["attn"]
    for w in ("wq", "wk"):
        attn[w] = attn[w] * np.float32(qk_scale)
    return base


def _stacked_state(base, C, seed=0):
    """C lanes of ``base``, each moved by 0.01 N(0, 1), momentum 0."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda x: np.stack(
        [x + np.float32(0.01) * rng.standard_normal(x.shape).astype(
            np.float32) for _ in range(C)]), base)
    return {"params": params, "mom": jax.tree.map(np.zeros_like, params),
            "step": np.zeros((), np.int32)}


def _batches(cfg, n, lead, seed=0, seq=16):
    toks = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, size=(n,) + lead + (4, seq + 1)).astype(np.int32)
    return [{"inputs": t[..., :-1], "labels": t[..., 1:]} for t in toks]


def _port_tree(flat, cfg):
    return flatten_tree(port_steps.state_tree(flat, port_steps.train_layout(
        cfg)))


def _assert_state(ref_state, port_state, port_cfg, mom_zero=False):
    for key, tol in (("params", PARAM_TOL), ("mom", MOM_TOL)):
        ref = flatten_tree(_np(ref_state[key]))
        port = _port_tree(port_state[key], port_cfg)
        assert sorted(ref) == sorted(port)
        for name in ref:
            got = port[name].numpy()
            if key == "mom" and mom_zero:
                assert not got.any(), name
            np.testing.assert_allclose(got, ref[name], rtol=0, atol=tol,
                                       err_msg=f"{key} {name}")
    assert port_state["step"] == int(ref_state["step"])


def _to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# host side, exactly


def test_token_stream_and_client_store_are_the_references():
    from repro.data.synthetic import make_token_stream as ref_stream
    from repro_torch.data.synthetic import make_token_stream

    for seed, v in ((0, 128), (7, 32768)):
        a = ref_stream(vocab_size=v, num_tokens=2_000, seed=seed)
        b = make_token_stream(vocab_size=v, num_tokens=2_000, seed=seed)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    rc, pc = _cfgs()
    ref = ref_train.ClientTokenStore(rc, 3, 2, 16, 4, seed=2)
    port = port_train.ClientTokenStore(pc, 3, 2, 16, 4, seed=2)
    for t in range(4):
        np.testing.assert_array_equal(ref.step_batch(t), port.step_batch(t))


@pytest.mark.parametrize("n", range(1, 10))
def test_host_mesh_shape_is_the_references(n):
    assert port_mesh._host_mesh_shape(n) == ref_mesh._host_mesh_shape(n)


def test_host_mesh_sizes_the_client_stack(monkeypatch):
    mesh = port_mesh.make_host_mesh("cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    monkeypatch.setattr(port_mesh, "visible_devices",
                        lambda device=None: [CPU] * 8)
    assert port_mesh.make_host_mesh("cpu").shape == {"data": 4, "model": 2}
    monkeypatch.setattr(port_mesh, "visible_devices", lambda device=None: [
        torch.device("cuda", 0), torch.device("cuda", 1)])
    with pytest.raises(NotImplementedError, match="ROADMAP A5.2"):
        port_mesh.make_host_mesh()


def test_metric_logger_records_are_the_references(tmp_path, capsys):
    from repro.utils.logging import MetricLogger as RefLogger
    from repro_torch.utils.logging import MetricLogger

    files = {}
    for name, cls in (("ref", RefLogger), ("port", MetricLogger)):
        path = tmp_path / name / "log.jsonl"
        log = cls(str(path))
        log.log(1, loss=6.5, tok_s=123.25)
        log.log(10, loss=np.float32(4.25), note="x")
        files[name] = [json.loads(line) for line in path.read_text()
                       .splitlines()]
        for rec in files[name]:
            assert isinstance(rec.pop("t"), float)
    assert files["ref"] == files["port"]
    err = capsys.readouterr().err.splitlines()
    assert err[:2] == err[2:]


# ---------------------------------------------------------------------------
# optimizers and schedules


def test_schedules_match_the_references():
    from repro.optim import schedules as R
    from repro_torch.optim import schedules as P

    pairs = [(R.constant(0.3), P.constant(0.3)),
             (R.robbins_monro(0.05, 0.75), P.robbins_monro(0.05, 0.75)),
             (R.robbins_monro(), P.robbins_monro()),
             (R.warmup_cosine(0.1, 5, 40, 1e-4),
              P.warmup_cosine(0.1, 5, 40, 1e-4)),
             (R.warmup_cosine(0.2, 0, 10), P.warmup_cosine(0.2, 0, 10)),
             (R.cosine_decay(), P.cosine_decay())]
    for ref, port in pairs:
        for t in (0, 1, 3, 5, 6, 17, 39, 40, 55):
            want, got = float(ref(t)), port(t)
            assert isinstance(got, np.float32)
            assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1e-12), (
                t, want, float(got))


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal((7,)).astype(np.float32)}}


@pytest.mark.parametrize("kind,kw", [
    ("sgd", {"momentum": 0.0}),
    ("sgd", {"momentum": 0.5}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("sgd", {"momentum": 0.5, "weight_decay": 0.01}),
    ("sgd", {"momentum": 0.5, "fused": True}),
    ("sgd", {"momentum": 0.9, "nesterov": True, "fused": True}),
    ("adamw", {}),
    ("adamw", {"weight_decay": 0.0, "b2": 0.999}),
])
def test_optimizers_match_the_references_over_three_updates(kind, kw):
    from repro.optim.adamw import AdamW as RefAdamW
    from repro.optim.sgd import SGD as RefSGD
    from repro_torch.optim import SGD, AdamW

    ref_opt, port_opt = ((RefSGD(**kw), SGD(**kw)) if kind == "sgd"
                         else (RefAdamW(**kw), AdamW(**kw)))
    rp = _opt_tree(0)
    pp = jax.tree.map(torch.from_numpy, rp)
    rs, ps = ref_opt.init(rp), port_opt.init(pp)
    for t in range(3):
        g = _opt_tree(t + 1)
        rp, rs = ref_opt.update(g, rs, rp, np.float32(0.05))
        pp, ps = port_opt.update(jax.tree.map(torch.from_numpy, g), ps, pp,
                                 0.05)
    for got, want in zip(jax.tree.leaves(jax.tree.map(np.asarray, pp)),
                         jax.tree.leaves(_np(rp))):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if kind == "adamw":
        assert int(ps["count"]) == int(rs["count"]) == 3


# ---------------------------------------------------------------------------
# the loss


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_and_gradient_match_jax_grad(masked):
    rc, pc = _cfgs()
    base = _weights(rc)
    batch = _batches(rc, 1, (), seed=3)[0]
    if masked:
        batch["mask"] = (np.random.default_rng(4).random((4, 16)) < 0.6
                         ).astype(np.float32)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: RT.lm_loss(
        p, b, rc)))(jax.tree.map(jnp.asarray, base),
                    jax.tree.map(jnp.asarray, batch))
    params = PT.lm_params_from_numpy(base, CPU)
    leaves = flatten_tree(params)
    for x in leaves.values():
        x.requires_grad_()
    got = PT.lm_loss(params, _to_torch(batch), pc)
    got.backward()
    assert abs(got.item() - float(loss)) <= 1e-5 * abs(float(loss))
    want = flatten_tree(_np(grads))
    for name, x in leaves.items():
        scale = max(float(np.abs(want[name]).max()), 1e-30)
        assert np.abs(x.grad.numpy() - want[name]).max() <= 1e-5 * scale, name


# ---------------------------------------------------------------------------
# the train step


@pytest.mark.parametrize("hop,fused,remat", [
    (True, False, "none"), (False, True, "none"), (True, True, "full")])
def test_pipelined_step_matches_the_reference(hop, fused, remat):
    rc, pc = _cfgs()
    kw = dict(learning_rate=0.1, momentum=0.5, fused_sgd=fused,
              hop_momentum=hop, remat=remat)
    ref_step, ref_sync = ref_steps.make_train_step(
        rc, RefTrainConfig(**kw), ref_mesh.make_host_mesh())
    ref_step, ref_sync = jax.jit(ref_step), jax.jit(ref_sync)
    port_step, port_sync = port_steps.make_train_step(pc, TrainConfig(**kw))
    state = _stacked_state(_weights(rc), 3)
    rs = jax.tree.map(jnp.asarray, state)
    ps = port_steps.train_state_from_numpy(state, CPU)
    for batch in _batches(rc, 3, (3,)):
        rs, rl = ref_step(rs, jax.tree.map(jnp.asarray, batch))
        ps, pl = port_step(ps, _to_torch(batch))
        assert abs(float(pl) - float(rl)) <= LOSS_TOL
        _assert_state(rs, ps, pc)
    _assert_state(ref_sync(rs), port_sync(ps), pc, mom_zero=True)


@pytest.mark.parametrize("fused", [False, True])
def test_remat_recomputes_the_same_step(fused):
    """``remat="full"`` (and ``"selective"``, read the same way) recomputes
    each layer in the backward: the same bits as keeping the activations."""
    rc, pc = _cfgs()
    state = _stacked_state(_weights(rc), 2)
    batch = _to_torch(_batches(rc, 1, (2,))[0])
    outs = []
    for remat in ("none", "full", "selective"):
        step, _ = port_steps.make_train_step(pc, TrainConfig(
            learning_rate=0.1, fused_sgd=fused, remat=remat))
        outs.append(step(port_steps.train_state_from_numpy(state, CPU),
                         batch))
    for s, loss in outs[1:]:
        assert float(loss) == float(outs[0][1])
        assert torch.equal(s["params"], outs[0][0]["params"])
        assert torch.equal(s["mom"], outs[0][0]["mom"])


def _serial_steps(pc):
    return port_steps.make_train_step(pc, TrainConfig(
        learning_rate=0.1, momentum=0.5, ring_mode="serial"))


def test_serial_step_matches_the_reference_at_one_client():
    rc, pc = _cfgs()
    tcfg = RefTrainConfig(learning_rate=0.1, momentum=0.5,
                          ring_mode="serial")
    ref_step, ref_sync = ref_steps.make_train_step(
        rc, tcfg, ref_mesh.make_host_mesh())
    ref_step = jax.jit(ref_step)
    base = _weights(rc)
    state = {"params": base, "mom": jax.tree.map(np.zeros_like, base),
             "step": np.zeros((), np.int32)}
    rs = jax.tree.map(jnp.asarray, state)
    ps = port_steps.train_state_from_numpy(state, CPU)
    assert ps["params"].dim() == 1
    port_step, port_sync = _serial_steps(pc)
    for batch in _batches(rc, 2, (1,)):
        rs, rl = ref_step(rs, jax.tree.map(jnp.asarray, batch))
        ps, pl = port_step(ps, _to_torch(batch))
        assert abs(float(pl) - float(rl)) <= LOSS_TOL
        _assert_state(rs, ps, pc)
    assert port_sync(ps) is ps


def test_serial_step_is_the_manual_chain_at_four_clients():
    rc, pc = _cfgs()
    base = _weights(rc)
    batch = _batches(rc, 1, (4,))[0]
    port_step, _ = _serial_steps(pc)
    state = port_steps.train_state_from_numpy(
        {"params": base, "mom": jax.tree.map(np.zeros_like, base),
         "step": 0}, CPU)
    state, loss = port_step(state, _to_torch(batch))

    # the chain by hand: the same visits in order, one logical model
    p = flatten_tree(PT.lm_params_from_numpy(base, CPU))
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    losses = []
    for q in range(4):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        from repro_torch.utils.tree import nest_tree
        lq = PT.lm_loss(nest_tree(leaves), {k: torch.from_numpy(v[q])
                                            for k, v in batch.items()}, pc)
        grads = torch.autograd.grad(lq, list(leaves.values()))
        losses.append(lq.item())
        for (k, v), g in zip(leaves.items(), grads):
            m[k] = 0.5 * m[k] + g
            p[k] = v.detach() - 0.1 * m[k]
    got = _port_tree(state["params"], pc)
    for k in p:
        np.testing.assert_allclose(got[k].numpy(), p[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    assert abs(float(loss) - float(np.mean(losses))) <= 1e-6
    assert state["step"] == 1


def test_train_loop_matches_the_reference_at_one_client(tmp_path, capsys,
                                                         monkeypatch):
    from repro.utils.logging import MetricLogger as RefLogger
    from repro_torch.utils.logging import MetricLogger

    rc, pc = _cfgs()
    kw = dict(param_dtype="float32", learning_rate=0.3, momentum=0.5,
              cloud_sync_every=5, fused_sgd=True)
    run = dict(steps=10, batch_per_client=2, seq_len=16, seed=0)
    init = _weights(rc)
    # the reference's loop draws its weights itself: hand it these
    monkeypatch.setattr(ref_train, "init_model", lambda rng, cfg: jax.tree.map(
        jnp.asarray, init))
    ref_out = ref_train.train_loop(
        rc, RefTrainConfig(**kw), log=RefLogger(str(tmp_path / "r.jsonl")),
        **run)
    port_out = port_train.train_loop(
        pc, TrainConfig(**kw), log=MetricLogger(str(tmp_path / "p.jsonl")),
        init_params=init, device="cpu", **run)
    assert sorted(port_out) == sorted(ref_out)
    assert port_out["params_m"] == ref_out["params_m"]
    recs = [[json.loads(line) for line in (tmp_path / f).read_text()
             .splitlines()] for f in ("r.jsonl", "p.jsonl")]
    assert [r["step"] for r in recs[0]] == [r["step"] for r in recs[1]] == [
        1, 10]
    for a, b in zip(*recs):
        assert sorted(a) == sorted(b)
        assert abs(a["loss"] - b["loss"]) <= LOOP_TOL
    for key in ("first_loss", "final_loss"):
        assert abs(port_out[key] - ref_out[key]) <= LOOP_TOL
    ref_line, port_line = capsys.readouterr().out.splitlines()
    assert ref_line == port_line


def test_train_loop_stacks_the_host_mesh_data_size(monkeypatch, capsys):
    rc, pc = _cfgs()
    monkeypatch.setattr(port_mesh, "visible_devices",
                        lambda device=None: [CPU] * 8)
    from repro_torch.utils.logging import MetricLogger

    out = port_train.train_loop(
        pc, TrainConfig(learning_rate=0.1, cloud_sync_every=2),
        steps=2, batch_per_client=1, seq_len=8,
        log=MetricLogger(quiet=True), device="cpu")
    assert "clients=4" in capsys.readouterr().out
    assert np.isfinite(out["final_loss"])


# ---------------------------------------------------------------------------
# port rules


C11_KNOBS = dict(optimizer="adamw", weight_decay=0.1,
                 compute_dtype="float32", dp_clip=1.0, dp_noise_mult=1.0)


def test_c11_both_steps_ignore_the_unread_knobs():
    """ROADMAP C11: the reference's LM step reads none of ``optimizer``,
    ``weight_decay``, ``compute_dtype``, ``dp_clip``, ``dp_noise_mult``
    (its traced step is the same program), and the port's follows it (the
    same bits)."""
    rc, pc = _cfgs()
    base = dict(learning_rate=0.1, momentum=0.5)
    state = _stacked_state(_weights(rc), 2)
    batch = _batches(rc, 1, (2,))[0]
    jaxprs = []
    for kw in (base, {**base, **C11_KNOBS}):
        step, _ = ref_steps.make_train_step(rc, RefTrainConfig(**kw),
                                            ref_mesh.make_host_mesh())
        jaxprs.append(str(jax.make_jaxpr(step)(
            jax.tree.map(jnp.asarray, state),
            jax.tree.map(jnp.asarray, batch))))
    assert jaxprs[0] == jaxprs[1]
    outs = []
    for kw in (base, {**base, **C11_KNOBS}):
        step, _ = port_steps.make_train_step(pc, TrainConfig(**kw))
        outs.append(step(port_steps.train_state_from_numpy(state, CPU),
                         _to_torch(batch)))
    (s0, l0), (s1, l1) = outs
    assert float(l0) == float(l1)
    assert torch.equal(s0["params"], s1["params"])
    assert torch.equal(s0["mom"], s1["mom"])


@pytest.mark.parametrize("arch,kw,match", [
    ("mamba2-2.7b", {}, "ROADMAP A10.5"),
    ("yi-9b", {"param_dtype": "bfloat16", "fused_sgd": True},
     "ROADMAP A10.6"),
    ("qwen3-moe-30b-a3b", {}, "ROADMAP A10"),
])
def test_unported_training_raises(arch, kw, match):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.configs.registry import get_smoke_config

    if arch.startswith("qwen"):
        cfg = ModelConfig(name="moe", family="moe", num_layers=2, d_model=64,
                          d_ff=128, vocab_size=128, num_heads=2,
                          num_kv_heads=2, num_experts=4, experts_per_token=2)
    else:
        cfg = get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match=match):
        port_steps.make_train_step(cfg, TrainConfig(**kw))


def test_unfused_bfloat16_step_runs_in_torch_ops():
    rc, pc = _cfgs()
    state = port_steps.train_state_from_numpy(_stacked_state(
        _weights(rc), 2), CPU)
    state = {k: (v.bfloat16() if torch.is_tensor(v) else v)
             for k, v in state.items()}
    step, sync = port_steps.make_train_step(pc, TrainConfig(
        param_dtype="bfloat16", learning_rate=0.1))
    state, loss = step(state, _to_torch(_batches(rc, 1, (2,))[0]))
    assert state["params"].dtype == torch.bfloat16
    assert np.isfinite(float(loss))


def test_importing_the_trainer_leaves_jax_unloaded():
    code = ("import sys, repro_torch.launch.train, repro_torch.optim\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
