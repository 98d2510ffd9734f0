"""The port's moe family against the JAX package's: qwen3-moe-30b-a3b (128
experts top-8, GQA 32/4 at head dim 128) and phi3.5-moe-42b-a6.6b (16
experts top-2, GQA 32/8), at their reduced configs with the reference's
weights carried across.

* Configs field-equal to the reference's, full and reduced, and resolved
  by the registry; spec trees with equal shapes and init kinds (the
  experts' (E, d, f) axis included) and the full parameter counts.
* ``router_topk`` on bfloat16 logits with many ties: the expert indices
  equal ``jax.lax.top_k``'s (ties to the lower index), at 128 experts
  top-8 and 16 experts top-2; ``load_balance_loss``.
* ``moe_block`` (one global capacity pool) and ``_moe_block_grouped`` (a
  pool a batch row) against the reference's at the reduced width, float32,
  within 1e-5 of the output scale, with a capacity that drops tokens and
  one that keeps them all; grouped = global at high capacity (the twin of
  ``tests/test_perf_variants.py``'s).
* The reduced models' ``forward`` logits and aux loss, ``decode_step`` at
  every position, ``decode_step`` against the port's own ``forward``
  within the reference's 3e-2 (``tests/test_models.py``: capacity drops
  differ between a prefill and B decode tokens; 1e-3 at a capacity that
  drops nothing), and one ``make_train_step`` step against the
  reference's, unfused and fused.

Tolerances: a block's output within ``BLOCK_TOL`` (1e-5) of its scale
(float32 products summed in another order); the models' logits at
``test_torch_lm_serve.py``'s float32 bounds (its docstring gives the
reasons); the aux loss within ``AUX_TOL`` (1e-6, a float32 sum of 2 x E
products); the train step at ``tests/test_torch_train.py``'s ``LOSS_TOL``,
``PARAM_TOL`` and ``MOM_TOL``, from the reference's weights with wq and wk
scaled by 0.1 (ROADMAP C12).
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import torch_parity  # noqa: F401  (one torch thread in each test worker)

from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from test_torch_lm_serve import _assert_f32, _decode_both, _flat, _weights

CPU = torch.device("cpu")
ARCHS = {"qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
         "phi3.5-moe-42b-a6.6b": "phi35_moe_42b"}
# the full configs' parameter counts, by the reference's model_specs
PARAMS = {"qwen3-moe-30b-a3b": 30_532_110_336,
          "phi3.5-moe-42b-a6.6b": 41_872_527_360}
# the full configs: (heads, kv heads, head dim, experts, top k)
SHAPES = {"qwen3-moe-30b-a3b": (32, 4, 128, 128, 8),
          "phi3.5-moe-42b-a6.6b": (32, 8, 128, 16, 2)}
BLOCK_TOL = 1e-5
AUX_TOL = 1e-6
DECODE_FORWARD_TOL = 3e-2     # tests/test_models.py, qwen3-moe's row
DENSE_DECODE_FORWARD_TOL = 1e-3   # the same test's dense rows


def _modules(arch):
    mod = ARCHS[arch]
    return (importlib.import_module(f"repro.configs.{mod}"),
            importlib.import_module(f"repro_torch.configs.{mod}"))


def _cfgs(arch, **kw):
    """The reduced config of ``arch`` in both packages, with ``kw``."""
    ref, port = _modules(arch)
    return (dataclasses.replace(ref.SMOKE, **kw),
            dataclasses.replace(port.SMOKE, **kw))


# ---------------------------------------------------------------------------
# configs and specs


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_and_resolve_in_the_registry(arch):
    from repro.configs import registry as ref_reg
    from repro_torch.configs import registry as reg

    ref, port = _modules(arch)
    assert dataclasses.asdict(port.CONFIG) == dataclasses.asdict(ref.CONFIG)
    assert dataclasses.asdict(port.SMOKE) == dataclasses.asdict(ref.SMOKE)
    for fn, ref_fn in ((reg.get_config, ref_reg.get_config),
                       (reg.get_smoke_config, ref_reg.get_smoke_config)):
        assert dataclasses.asdict(fn(arch)) == dataclasses.asdict(
            ref_fn(arch))
    cfg = port.CONFIG
    assert cfg.family == "moe"
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            cfg.num_experts, cfg.experts_per_token) == SHAPES[arch]


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_specs_have_the_reference_shapes_and_init_kinds(arch, size):
    from repro.nn.module import param_count as ref_param_count
    from repro_torch.nn.module import param_count

    ref_mod, port_mod = _modules(arch)
    ref_cfg, cfg = ((ref_mod.SMOKE, port_mod.SMOKE) if size == "smoke"
                    else (ref_mod.CONFIG, port_mod.CONFIG))
    assert PT.block_pattern(cfg) == RT.block_pattern(ref_cfg) == [
        ("attn", "moe")]
    ref, port = _flat(RT.model_specs(ref_cfg)), _flat(PT.model_specs(cfg))
    assert list(ref) == list(port)
    for k in ref:
        assert tuple(port[k].shape) == tuple(ref[k].shape), k
        assert (port[k].init, port[k].scale) == (ref[k].init, ref[k].scale), k
    e = cfg.num_experts
    assert tuple(port["blocks/pos0/moe/w_gate"].shape) == (
        cfg.num_layers, e, cfg.d_model, cfg.d_ff)
    n = param_count(PT.model_specs(cfg))
    assert n == ref_param_count(RT.model_specs(ref_cfg))
    if size == "full":
        assert n == PARAMS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_from_numpy_carries_the_experts(arch):
    ref_cfg, cfg = _cfgs(arch)
    params, port = _weights(ref_cfg)
    ref, got = _flat(jax.tree.map(np.asarray, params)), _flat(port)
    assert list(ref) == list(got) == list(_flat(PT.model_specs(cfg)))
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k].numpy())


# ---------------------------------------------------------------------------
# the router


def _tied_logits(n, e, seed):
    """bfloat16 logits (n, e) on a coarse grid, so many rows tie among
    their largest values, as the router's bfloat16 logits do."""
    rng = np.random.default_rng(seed)
    grid = rng.integers(-12, 13, size=(n, e)).astype(np.float32) / 8
    return jnp.asarray(grid, jnp.bfloat16)


@pytest.mark.parametrize("e,k", [(128, 8), (16, 2)])
def test_router_topk_breaks_ties_as_the_reference(e, k):
    logits = _tied_logits(2048, e, seed=e)
    w_ref, i_ref, p_ref = RM.router_topk(logits, k)
    port = torch.from_numpy(np.array(logits.astype(jnp.float32))).bfloat16()
    w, i, p = PM.router_topk(port, k)
    # the draw ties: a quarter of the rows or more hold equal
    # probabilities among their k + 1 largest, where the order of the
    # picks is the tie-break's alone
    top = np.sort(np.asarray(p_ref), -1)[:, ::-1][:, :k + 1]
    assert np.mean((np.diff(top, axis=-1) == 0).any(-1)) > 0.25
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("e,k", [(128, 8), (16, 2)])
def test_load_balance_loss_matches_the_reference(e, k):
    logits = _tied_logits(512, e, seed=e + 1).astype(jnp.float32)
    _, i_ref, p_ref = RM.router_topk(logits, k)
    want = RM.load_balance_loss(p_ref, i_ref, e)
    _, i, p = PM.router_topk(torch.from_numpy(np.asarray(logits)), k)
    got = PM.load_balance_loss(p, i, e)
    assert abs(float(got) - float(want)) <= AUX_TOL * max(1.0, float(want))


# ---------------------------------------------------------------------------
# the block


def _block_case(arch, seed=0, **kw):
    """The reduced config's first moe block, its weights and an input
    (2, 24, d) drawn with numpy, in both packages (float32)."""
    ref_cfg, cfg = _cfgs(arch, dtype="float32", **kw)
    params, port = _weights(ref_cfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    ref_p = jax.tree.map(lambda a: a[0], params["blocks"]["pos0"]["moe"])
    port_p = {k: v[0] for k, v in port["blocks"]["pos0"]["moe"].items()}
    return ref_cfg, cfg, ref_p, port_p, x


def _kept(cfg, port_p, x, grouped):
    """How many (token, slot) routings the block keeps, of how many."""
    flat = PT.L.rmsnorm(torch.from_numpy(x), port_p["norm"], cfg.norm_eps)
    b, s, _ = x.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    rows = flat if grouped else flat.reshape(1, b * s, -1)
    n = rows.shape[1]
    cap = (max(int(cfg.capacity_factor * n * k / e), 4) if grouped
           else max(int(cfg.capacity_factor * n * k / e), 8))
    kept = 0
    for r in rows:
        _, idx, _ = PM.router_topk(r @ port_p["w_router"], k)
        counts = torch.bincount(idx.reshape(-1), minlength=e)
        kept += int(torch.clamp(counts, max=cap).sum())
    return kept, b * s * k


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("capacity_factor", [0.5, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_the_reference(arch, capacity_factor, grouped):
    ref_cfg, cfg, ref_p, port_p, x = _block_case(
        arch, capacity_factor=capacity_factor, moe_grouped_dispatch=grouped)
    want, want_aux = RM.moe_block(ref_p, jnp.asarray(x), ref_cfg)
    got, aux = PM.moe_block(port_p, torch.from_numpy(x), cfg)
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= BLOCK_TOL * scale
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL
    kept, total = _kept(cfg, port_p, x, grouped)
    if capacity_factor < 1:
        assert kept < total            # the capacity drops tokens
    else:
        assert kept == total


@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_dispatch_equals_global_at_high_capacity(arch):
    """The twin of ``tests/test_perf_variants.py``'s: with every token
    kept, the two layouts compute the same function."""
    _, cfg = _cfgs(arch, dtype="float32", capacity_factor=8.0)
    _, port = _weights(_cfgs(arch, dtype="float32")[0])
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32))
    l0, _ = PT.forward(port, toks, cfg)
    l1, _ = PT.forward(port, toks, dataclasses.replace(
        cfg, moe_grouped_dispatch=True))
    rel = float((l0 - l1).abs().max() / l0.abs().max())
    assert rel < 1e-5, rel


# ---------------------------------------------------------------------------
# the models


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_the_reference(arch):
    ref_cfg, cfg = _cfgs(arch, dtype="float32")
    params, port = _weights(ref_cfg)
    x = _tokens(cfg, (2, 48))
    ref, ref_aux = RT.forward(params, jnp.asarray(x), ref_cfg)
    got, aux = PT.forward(port, torch.from_numpy(x), cfg)
    assert got.shape == (2, 48, cfg.vocab_size) and got.dtype == torch.float32
    _assert_f32(ref, got)
    # two layers' terms, each near router_aux_coef (0.01) at a uniform load
    assert float(aux) > 0.01
    assert abs(float(aux) - float(ref_aux)) <= AUX_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_the_reference_at_every_step(arch):
    ref_cfg, cfg = _cfgs(arch, dtype="float32")
    refs, ports = _decode_both(ref_cfg, cfg, steps=16)
    _assert_f32(np.concatenate(refs, 1), torch.cat(ports, 1))


@pytest.mark.parametrize("arch,capacity_factor,tol", [
    ("qwen3-moe-30b-a3b", 1.25, DECODE_FORWARD_TOL),
    ("qwen3-moe-30b-a3b", 8.0, DENSE_DECODE_FORWARD_TOL),
    ("phi3.5-moe-42b-a6.6b", 8.0, DENSE_DECODE_FORWARD_TOL)])
def test_decode_matches_forward(arch, capacity_factor, tol):
    """The port's decode with cache against its own forward: at the
    config's capacity at the reference's tolerance for qwen3-moe
    (``tests/test_models.py``), since a prefill's capacity pool and a decode
    step's B tokens drop differently; at a capacity that drops nothing,
    at the dense archs' 1e-3."""
    ref_cfg, cfg = _cfgs(arch, dtype="float32",
                         capacity_factor=capacity_factor)
    _, port = _weights(ref_cfg)
    x = _tokens(cfg, (2, 16), seed=2)
    full, _ = PT.forward(port, torch.from_numpy(x), cfg)
    cache = PT.init_cache(cfg, 2, 16, dtype=torch.float32, device=CPU)
    outs = []
    for t in range(16):
        lg, cache = PT.decode_step(port, torch.from_numpy(x[:, t:t + 1]),
                                   cache, t, cfg)
        outs.append(lg)
    rel = float((full - torch.cat(outs, 1)).abs().max() / full.abs().max())
    assert rel < tol, rel


def test_the_moe_fleet_decoder_still_raises_naming_its_item():
    from repro_torch.serve.fleet import FleetDecoder

    _, cfg = _cfgs("qwen3-moe-30b-a3b")
    with pytest.raises(NotImplementedError, match="ROADMAP A10.4b-fleet"):
        FleetDecoder(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP A10.4b-fleet"):
        PT.decode_step_lanes({}, torch.zeros(1, dtype=torch.long),
                             torch.zeros(1, 1, dtype=torch.int32), {}, 0, cfg)


def test_serve_cli_runs_qwen3_moe_smoke_on_the_cpu():
    import io
    from contextlib import redirect_stdout

    from repro_torch.launch.serve import main

    buf = io.StringIO()
    with redirect_stdout(buf):
        main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
              "--batch", "2", "--prompt-len", "4", "--new-tokens", "3"])
    assert "generated shape: (2, 7) on cpu" in buf.getvalue()


# ---------------------------------------------------------------------------
# training


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_matches_the_reference(fused):
    """One pipelined step of reduced qwen3-moe at C = 2 lanes (float32),
    each lane on its own batch, its aux loss in the loss; then the cloud
    sync."""
    from repro.configs.base import TrainConfig as RefTrainConfig
    from repro.launch import mesh as ref_mesh
    from repro.launch import steps as ref_steps
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps as port_steps
    from test_torch_train import (
        LOSS_TOL, _assert_state, _batches, _stacked_state, _to_torch,
    )
    from test_torch_train import _weights as train_weights

    rc, pc = _cfgs("qwen3-moe-30b-a3b", dtype="float32", num_layers=2,
                   d_model=64, d_ff=128, num_heads=2, num_kv_heads=2,
                   head_dim=32, vocab_size=128)
    kw = dict(learning_rate=0.1, momentum=0.5, fused_sgd=fused)
    ref_step, ref_sync = ref_steps.make_train_step(
        rc, RefTrainConfig(**kw), ref_mesh.make_host_mesh())
    port_step, port_sync = port_steps.make_train_step(pc, TrainConfig(**kw))
    state = _stacked_state(train_weights(rc), 2)
    rs = jax.tree.map(jnp.asarray, state)
    ps = port_steps.train_state_from_numpy(state, CPU)
    batch = _batches(rc, 1, (2,))[0]
    rs, rl = jax.jit(ref_step)(rs, jax.tree.map(jnp.asarray, batch))
    ps, pl = port_step(ps, _to_torch(batch))
    assert abs(float(pl) - float(rl)) <= LOSS_TOL
    _assert_state(rs, ps, pc)
    _assert_state(jax.jit(ref_sync)(rs), port_sync(ps), pc, mom_zero=True)


def test_importing_the_moe_modules_leaves_jax_unloaded():
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    mods = ["repro_torch.models.moe", "repro_torch.configs.qwen3_moe_30b_a3b",
            "repro_torch.configs.phi35_moe_42b"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
