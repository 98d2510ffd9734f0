"""The port's dense-LM serving path (yi-9b's reduced config) against the
JAX package's, with the reference's weights carried across.

* Configs: ``configs/registry.py`` and ``configs/yi_9b.py`` are pinned
  equal to the reference's; the vlm, audio, moe and hybrid archs
  resolve.
* ``nn/module.py``: the spec tree's shapes and init kinds equal the
  reference's, and each kind draws what it should.
* ``forward``, ``decode_step`` at every position and greedy
  ``prefill_and_decode`` against ``repro.models.transformer`` /
  ``repro.launch.serve``, with ``lm_params_from_numpy`` weights.

Tolerances and their reasons. The reference's ``fan_in`` rule reads
``shape[-2]``, so ``wq``/``wk`` draw with std 1/sqrt(heads): attention
scores have a std near 90 at this size and most softmax rows are nearly
one-hot. A float32 projection summed in another order (about 3e-7
relative) then moves the few rows whose top two scores nearly tie, and
their logits move with them.
* float32: every position's logits within 5e-4 * max(1, max|logit|) of
  the reference's (measured up to 1.1e-4 at such a row), and the median
  position within 1e-5 (the rest agree at float32 noise, ~7e-7).
* bfloat16: the reference's jnp attention rounds the prefill scores and
  the probabilities to bfloat16 (``layers.py:100``, ``:106``, ``:176``);
  the port's kernels keep both in float32, as the Pallas kernels'
  contract does (ROADMAP C3). So in
  bfloat16 the port is held against the reference model with its two
  attention call sites routed to the kernels' own oracles
  (``attention_reference``, ``decode_attention_reference``): 95% of
  positions within 3e-2 * max|logit|, every position within 1e-1, and the
  top-1 token equal at >= 95% of positions. What is left is bfloat16
  rounding of the projections' outputs, one ulp here and there.
"""
import dataclasses
import io
import math
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.models.layers as ref_layers
from repro.configs.yi_9b import SMOKE as REF_SMOKE
from repro.kernels.decode_attention.ref import decode_attention_reference
from repro.kernels.flash_attention.ref import attention_reference
from repro.models import transformer as RT
from repro_torch.configs.yi_9b import SMOKE
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import transformer as PT

CPU = torch.device("cpu")
F32_MAX, F32_MEDIAN = 5e-4, 1e-5
BF16_BULK, BF16_MAX, BF16_TOP1 = 3e-2, 1e-1, 0.95


def _cfgs(**kw):
    return (dataclasses.replace(REF_SMOKE, **kw),
            dataclasses.replace(SMOKE, **kw))


def _weights(ref_cfg, seed=0):
    """The reference's initial weights, and the same values in the port."""
    params = RT.init_model(jax.random.PRNGKey(seed),
                           dataclasses.replace(ref_cfg, dtype="float32"))
    return params, PT.lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                           CPU)


def _tokens(cfg, shape, seed=0):
    """Token ids of ``shape`` (B, S) for a token model; for an embeds model
    (``input_mode="embeds"``) float32 embeds (B, S, d) drawn 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode != "tokens":
        return (0.1 * rng.standard_normal(shape + (cfg.d_model,))).astype(
            np.float32)
    return rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)


def _rel_err(ref, port):
    """Per-position max |diff| over the vocabulary, relative to the
    reference's logit scale."""
    ref = np.asarray(ref, np.float32)
    port = port.float().numpy() if hasattr(port, "numpy") else port
    scale = max(1.0, float(np.abs(ref).max()))
    return np.abs(ref - port).max(-1).ravel() / scale


def _assert_f32(ref, port):
    e = _rel_err(ref, port)
    assert e.max() <= F32_MAX, e.max()
    assert np.median(e) <= F32_MEDIAN, np.median(e)


def _assert_bf16(ref, port):
    ref = np.asarray(ref, np.float32)
    port = port.float().numpy()
    e = _rel_err(ref, port)
    assert np.mean(e <= BF16_BULK) >= 0.95, np.sort(e)[-10:]
    assert e.max() <= BF16_MAX, e.max()
    top1 = np.mean(ref.argmax(-1) == port.argmax(-1))
    assert top1 >= BF16_TOP1, top1


@pytest.fixture
def kernel_contract_reference(monkeypatch):
    """Route the reference model's two attention call sites to the Pallas
    kernels' oracles (the port's kernels' contract). The JAX package's
    files are untouched; only this test's module attributes change."""
    def causal(q, k, v, *, sliding_window=0):
        t = (0, 2, 1, 3)
        return attention_reference(q.transpose(t), k.transpose(t),
                                   v.transpose(t), causal=True,
                                   window=sliding_window).transpose(t)

    def decode(q, k_cache, v_cache, pos, *, sliding_window=0):
        b, _, h, hd = q.shape
        kv = k_cache.shape[2]
        lengths = jnp.full((b,), pos + 1, jnp.int32)
        out = decode_attention_reference(
            q[:, 0].reshape(b, kv, h // kv, hd), k_cache.transpose(0, 2, 1, 3),
            v_cache.transpose(0, 2, 1, 3), lengths, window=sliding_window)
        return out.reshape(b, 1, h, hd)

    monkeypatch.setattr(ref_layers, "causal_attention", causal)
    monkeypatch.setattr(ref_layers, "decode_attention", decode)


# ---------------------------------------------------------------------------
# configs and specs


def _port_cfg(ref_cfg):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**dataclasses.asdict(ref_cfg))


def test_registry_and_yi_9b_configs_equal_the_reference():
    from repro.configs import registry as ref_reg
    from repro.configs.yi_9b import CONFIG as REF_CONFIG
    from repro_torch.configs import registry as reg
    from repro_torch.configs.yi_9b import CONFIG

    assert reg.ARCH_IDS == ref_reg.ARCH_IDS
    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(REF_CONFIG)
    assert dataclasses.asdict(SMOKE) == dataclasses.asdict(REF_SMOKE)
    for arch in ("yi-9b", "fedsr-mlp", "fedsr-cnn"):
        assert (dataclasses.asdict(reg.get_config(arch))
                == dataclasses.asdict(ref_reg.get_config(arch)))
        assert (dataclasses.asdict(reg.get_smoke_config(arch))
                == dataclasses.asdict(ref_reg.get_smoke_config(arch)))
    for arch in ref_reg.ARCH_IDS:              # the reduction, for every arch
        ref_cfg = ref_reg.get_config(arch)
        assert (dataclasses.asdict(reg.reduce_for_smoke(_port_cfg(ref_cfg)))
                == dataclasses.asdict(ref_reg.reduce_for_smoke(ref_cfg)))
    assert SMOKE.resolved_head_dim == REF_SMOKE.resolved_head_dim
    assert CONFIG.resolved_head_dim == 128


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "jamba-v0.1-52b"])
def test_unported_archs_raise_naming_their_roadmap_item(arch):
    """qwen3-moe (ROADMAP A10.4b) and jamba (A10.4c), ported since,
    resolve to the reference's configs."""
    from repro.configs import registry as ref_reg
    from repro_torch.configs import registry as reg
    for fn in ("get_config", "get_smoke_config"):
        assert (dataclasses.asdict(getattr(reg, fn)(arch))
                == dataclasses.asdict(getattr(ref_reg, fn)(arch)))


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "musicgen-large"])
def test_the_vlm_and_audio_archs_resolve(arch):
    from repro_torch.configs.registry import get_config, get_smoke_config
    for fn in (get_config, get_smoke_config):
        assert fn(arch).name == arch


@pytest.mark.parametrize("family", ["moe", "hybrid"])
def test_unported_families_raise_naming_their_roadmap_item(family):
    """The moe family (ROADMAP A10.4b) and the hybrid one (A10.4c, at
    jamba's reduced config: a hybrid pattern needs ``attn_every``), ported
    since, build the reference's specs."""
    if family == "hybrid":
        from repro.configs.jamba_v0_1_52b import SMOKE as ref_cfg
        from repro_torch.configs.jamba_v0_1_52b import SMOKE as cfg
    else:
        ref_cfg = dataclasses.replace(REF_SMOKE, family=family)
        cfg = dataclasses.replace(SMOKE, family=family)
    assert PT.block_pattern(cfg) == RT.block_pattern(ref_cfg)
    ref = _flat(RT.model_specs(ref_cfg))
    port = _flat(PT.model_specs(cfg))
    assert list(ref) == list(port)
    assert all(tuple(port[k].shape) == tuple(ref[k].shape) for k in ref)


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_the_vlm_and_audio_families_build_the_dense_specs(family):
    cfg = dataclasses.replace(SMOKE, family=family)
    assert PT.block_pattern(cfg) == [("attn", "dense")]
    assert _flat(PT.model_specs(cfg)).keys() == _flat(
        PT.model_specs(SMOKE)).keys()


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch_cfg", ["smoke", "full"])
def test_model_specs_have_the_reference_shapes_and_init_kinds(arch_cfg):
    from repro.configs.yi_9b import CONFIG as REF_CONFIG
    from repro.nn.module import param_count as ref_param_count
    from repro_torch.configs.yi_9b import CONFIG
    from repro_torch.nn.module import param_count

    ref_cfg, cfg = ((REF_SMOKE, SMOKE) if arch_cfg == "smoke"
                    else (REF_CONFIG, CONFIG))
    ref, port = _flat(RT.model_specs(ref_cfg)), _flat(PT.model_specs(cfg))
    assert list(ref) == list(port)
    for k in ref:
        assert tuple(port[k].shape) == tuple(ref[k].shape), k
        assert (port[k].init, port[k].scale) == (ref[k].init, ref[k].scale), k
    assert param_count(PT.model_specs(cfg)) == ref_param_count(
        RT.model_specs(ref_cfg))


def test_registry_dispatches_specs_and_init_by_family():
    from repro_torch.configs.fedsr_cnn import CONFIG as CNN
    from repro_torch.configs.fedsr_mlp import CONFIG as MLP
    from repro_torch.models.registry import init_for, specs_for
    from repro_torch.models.small import cnn_specs, mlp_specs

    assert specs_for(SMOKE) == PT.model_specs(SMOKE)
    assert specs_for(MLP) == mlp_specs(MLP)
    p = init_for(torch.Generator().manual_seed(0), SMOKE, CPU)
    q = PT.init_model(torch.Generator().manual_seed(0), SMOKE, CPU)
    assert all(torch.equal(a, b) for a, b in
               zip(_flat(p).values(), _flat(q).values()))
    assert specs_for(CNN) == cnn_specs(CNN)
    # the hybrid family (jamba) dispatches through model_specs too
    from repro.configs.jamba_v0_1_52b import SMOKE as REF_JAMBA
    from repro_torch.configs.jamba_v0_1_52b import SMOKE as JAMBA
    ref, port = _flat(RT.model_specs(REF_JAMBA)), _flat(specs_for(JAMBA))
    assert list(ref) == list(port)
    assert all(tuple(port[k].shape) == tuple(ref[k].shape) for k in ref)


def test_init_params_draws_each_kind():
    from repro_torch.nn.module import ParamSpec, init_params

    specs = {"b": {"fan": ParamSpec((2, 64, 32, 16), init="fan_in"),
                   "norm": ParamSpec((3, 8), init="ones")},
             "a": ParamSpec((256, 64), init="embed"),
             "c": ParamSpec((128, 64), init="normal", scale=2.0),
             "z": ParamSpec((5,), init="zeros")}
    p = init_params(torch.Generator().manual_seed(0), specs, CPU)
    assert list(p) == ["a", "b", "c", "z"] and list(p["b"]) == ["fan", "norm"]
    assert torch.equal(p["b"]["norm"], torch.ones(3, 8))
    assert torch.equal(p["z"], torch.zeros(5))
    # fan_in reads shape[-2]: heads (32), not d_model (64)
    for x, std in ((p["b"]["fan"], 1 / math.sqrt(32)), (p["a"], 0.02),
                   (p["c"], 2.0)):
        assert abs(x.std().item() / std - 1) < 0.05, (x.std(), std)
    # leaves draw in sorted order, depth first, from one generator
    q = init_params(torch.Generator().manual_seed(0), {"a": specs["a"]}, CPU)
    assert torch.equal(p["a"], q["a"])
    again = init_params(torch.Generator().manual_seed(0), specs, CPU)
    assert all(torch.equal(x, y) for x, y in
               zip(_flat(p).values(), _flat(again).values()))
    with pytest.raises(ValueError):
        init_params(torch.Generator(), {"x": ParamSpec((2,), init="lecun")},
                    CPU)


def test_lm_params_from_numpy_keeps_the_reference_tree():
    params, port = _weights(REF_SMOKE)
    ref = _flat(jax.tree.map(np.asarray, params))
    got = _flat(port)
    assert list(ref) == list(got)
    assert "blocks/pos0/attn/wq" in got and got["blocks/pos0/attn/wq"].shape == (
        2, 256, 4, 64)
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k].numpy())


# ---------------------------------------------------------------------------
# forward (prefill)


@pytest.mark.parametrize("variant", [{}, {"sliding_window": 8},
                                     {"attn_block": 16}])
def test_forward_float32_matches_reference(variant):
    ref_cfg, cfg = _cfgs(dtype="float32", **variant)
    params, port = _weights(ref_cfg)
    toks = _tokens(cfg, (2, 48))
    ref, _ = RT.forward(params, jnp.asarray(toks), ref_cfg)
    got, aux = PT.forward(port, torch.from_numpy(toks), cfg)
    assert got.shape == (2, 48, cfg.vocab_size) and got.dtype == torch.float32
    assert float(aux) == 0.0
    _assert_f32(ref, got)


def test_forward_bfloat16_matches_the_kernel_contract_reference(
        kernel_contract_reference):
    ref_cfg, cfg = _cfgs(dtype="bfloat16")
    params, port = _weights(ref_cfg)
    toks = _tokens(cfg, (2, 40))
    ref, _ = RT.forward(params, jnp.asarray(toks), ref_cfg)
    got, _ = PT.forward(port, torch.from_numpy(toks), cfg)
    assert got.dtype == torch.bfloat16
    _assert_bf16(ref, got)


def test_prefill_step_is_forward_and_never_launches_on_the_cpu():
    from repro_torch.launch.steps import make_prefill_step

    _, cfg = _cfgs(dtype="float32")
    _, port = _weights(REF_SMOKE)
    toks = torch.from_numpy(_tokens(cfg, (1, 16)))
    before = flash_attention.launches
    got = make_prefill_step(cfg)(port, toks)
    assert torch.equal(got, PT.forward(port, toks, cfg)[0])
    assert flash_attention.launches == before == 0


# ---------------------------------------------------------------------------
# decode


def _decode_both(ref_cfg, cfg, steps, batch=2, cache_len=None):
    """Feed the same tokens (an embeds model: embeds) position by position
    through both packages' ``decode_step``; returns the per-step logits
    (ref list, port list)."""
    from repro_torch.launch.steps import make_serve_step

    params, port = _weights(ref_cfg)
    toks = _tokens(cfg, (batch, steps), seed=1)
    cache_len = cache_len or steps
    rcache = RT.init_cache(ref_cfg, batch, cache_len, dtype=jnp.float32)
    pcache = PT.init_cache(cfg, batch, cache_len, dtype=torch.float32,
                           device=CPU)
    rstep = jax.jit(lambda p, t, c, i: RT.decode_step(p, t, c, i, ref_cfg))
    pstep = make_serve_step(cfg)
    refs, ports = [], []
    for i in range(steps):
        rl, rcache = rstep(params, jnp.asarray(toks[:, i:i + 1]), rcache,
                           jnp.asarray(i))
        pl, pcache = pstep(port, pcache, torch.from_numpy(toks[:, i:i + 1]), i)
        assert pl.shape == (batch, 1, cfg.vocab_size)
        refs.append(np.asarray(rl, np.float32))
        ports.append(pl)
    # the caches agree too (written in place); in bfloat16 they hold
    # bfloat16-rounded k and v, one ulp (2**-8 relative) apart here and there
    tol = 1e-4 if cfg.dtype == "float32" else 1e-2
    for k in ("k", "v"):
        np.testing.assert_allclose(
            pcache["pos0"]["attn"][k].numpy(),
            np.asarray(rcache["pos0"]["attn"][k]), atol=10 * tol, rtol=tol)
    return refs, ports


@pytest.mark.parametrize("variant", [
    {}, {"sliding_window": 8}, {"sliding_window": 8, "rolling_cache": True}])
def test_decode_step_float32_matches_reference_at_every_step(variant):
    ref_cfg, cfg = _cfgs(dtype="float32", **variant)
    refs, ports = _decode_both(ref_cfg, cfg, steps=20)
    assert decode_attention.launches == 0
    for r, p in zip(refs, ports):
        _assert_f32(r, p)


def test_decode_step_bfloat16_matches_the_kernel_contract_reference(
        kernel_contract_reference):
    ref_cfg, cfg = _cfgs(dtype="bfloat16")
    refs, ports = _decode_both(ref_cfg, cfg, steps=20)
    _assert_bf16(np.concatenate(refs, 1), torch.cat(ports, 1))


def test_greedy_prefill_and_decode_gives_the_reference_tokens():
    from repro.launch.serve import prefill_and_decode as ref_generate
    from repro_torch.launch.serve import prefill_and_decode

    ref_cfg, cfg = _cfgs(dtype="float32")
    params, port = _weights(ref_cfg)
    prompts = _tokens(cfg, (3, 12), seed=2)
    want, _ = ref_generate(ref_cfg, params, jnp.asarray(prompts), max_len=28,
                           new_tokens=16)
    got, stats = prefill_and_decode(cfg, port, torch.from_numpy(prompts),
                                    max_len=28, new_tokens=16)
    assert got.dtype == torch.int32 and got.shape == (3, 28)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(stats) == {"prefill_s", "decode_s", "decode_tok_s"}


def test_temperature_sampling_is_seeded():
    from repro_torch.launch.serve import prefill_and_decode

    _, cfg = _cfgs(dtype="float32")
    _, port = _weights(REF_SMOKE)
    prompts = torch.from_numpy(_tokens(cfg, (2, 4)))
    runs = [prefill_and_decode(cfg, port, prompts, max_len=12, new_tokens=8,
                               temperature=1.0, seed=s)[0] for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab_size


def test_serve_cli_runs_the_smoke_config_on_the_cpu():
    from repro_torch.launch.serve import main

    buf = io.StringIO()
    with redirect_stdout(buf):
        main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
              "4", "--new-tokens", "3"])
    out = buf.getvalue()
    assert "generated shape: (2, 7) on cpu" in out
    assert "decode_tok_s" in out


def test_importing_the_serving_path_leaves_jax_unloaded():
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    mods = ["repro_torch.launch.serve", "repro_torch.launch.steps",
            "repro_torch.models.registry", "repro_torch.configs.registry",
            "repro_torch.kernels.flash_attention.kernel",
            "repro_torch.kernels.decode_attention.kernel"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
