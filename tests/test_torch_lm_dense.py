"""The port's other dense LMs — stablelm-12b, granite-8b and deepseek-7b —
against the JAX package's, with the reference's weights carried across.

The three are llama-arch ``dense`` configs, the family of yi-9b
(``tests/test_torch_lm_serve.py``); what is new at their shapes:

* stablelm-12b's head dim is 5120 / 32 = 160, which the port's attention
  kernels take since this slice. Its reduced config has hd 64 (the
  reduction sets it), so every test below also runs a narrow hd-160
  variant, ``dataclasses.replace(SMOKE, head_dim=160)`` in both packages,
  on the plain versions the CPU runs.
* deepseek-7b is MHA (kv = heads = 32); its reduced config keeps the
  reference's ``num_kv_heads=4`` override, so with 4 heads its decode runs
  G = 1.
* granite-8b has a vocabulary of 49,152 (its reduced one 512).

Configs are field-equal to the reference's; ``model_specs`` of the full
configs have the reference's shapes and init kinds (abstract: nothing is
allocated). At the reduced sizes ``forward``, ``decode_step`` at every
position and greedy ``prefill_and_decode`` agree with the reference, and
``--arch <arch> --smoke --device cpu`` runs through the CLI.

Tolerances are ``tests/test_torch_lm_serve.py``'s, imported from it, and
for the same reasons (its docstring):
* float32: every position's logits within 5e-4 * max(1, max|logit|) of
  the reference's, the median position within 1e-5 (``_assert_f32``).
* bfloat16, against the reference model with its two attention call sites
  routed to the kernels' oracles (ROADMAP C3): 95% of positions within
  3e-2 * max|logit|, every position within 1e-1, the top-1 token equal at
  >= 95% of positions (``_assert_bf16``).
"""
import dataclasses
import importlib
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.models import transformer as RT
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import transformer as PT
from test_torch_lm_serve import (  # noqa: F401  (a fixture, used by name)
    _assert_bf16, _assert_f32, _decode_both, _flat, _tokens, _weights,
    kernel_contract_reference,
)

ARCHS = {"stablelm-12b": "stablelm_12b", "granite-8b": "granite_8b",
         "deepseek-7b": "deepseek_7b"}
# the full configs' attention shapes: (heads, kv heads, head dim)
HEADS = {"stablelm-12b": (32, 8, 160), "granite-8b": (32, 8, 128),
         "deepseek-7b": (32, 32, 128)}
VARIANTS = {"smoke": {}, "hd160": {"head_dim": 160}}
# archs once left for later, all ported since (tests/test_torch_moe.py,
# tests/test_torch_hybrid.py)
UNPORTED = ("jamba-v0.1-52b", "qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b")
# the vlm and audio archs, ported since (tests/test_torch_lm_multimodal.py)
MULTIMODAL = ("musicgen-large", "llava-next-mistral-7b")


def _modules(arch):
    mod = ARCHS[arch]
    return (importlib.import_module(f"repro.configs.{mod}"),
            importlib.import_module(f"repro_torch.configs.{mod}"))


def _cfgs(arch, variant="smoke", **kw):
    """The reduced config of ``arch`` in both packages, with the variant's
    and ``kw``'s overrides."""
    ref, port = _modules(arch)
    kw = {**VARIANTS[variant], **kw}
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
    assert (dataclasses.asdict(reg.get_config(arch))
            == dataclasses.asdict(ref_reg.get_config(arch)))
    assert (dataclasses.asdict(reg.get_smoke_config(arch))
            == dataclasses.asdict(ref_reg.get_smoke_config(arch)))
    h, kv, hd = HEADS[arch]
    cfg = port.CONFIG
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim) == (
        h, kv, hd)
    assert port.SMOKE.resolved_head_dim == ref.SMOKE.resolved_head_dim == 64


@pytest.mark.parametrize("arch", UNPORTED)
def test_the_other_archs_still_raise_naming_a10(arch):
    """The moe archs (A10.4b) and jamba (A10.4c), ported since, resolve to
    the reference's configs."""
    from repro.configs import registry as ref_reg
    from repro_torch.configs import registry as reg
    for fn in ("get_config", "get_smoke_config"):
        assert (dataclasses.asdict(getattr(reg, fn)(arch))
                == dataclasses.asdict(getattr(ref_reg, fn)(arch)))


@pytest.mark.parametrize("arch", MULTIMODAL)
def test_the_multimodal_archs_now_resolve(arch):
    from repro_torch.configs.registry import get_config, get_smoke_config
    for fn in (get_config, get_smoke_config):
        assert fn(arch).name == arch


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_specs_have_the_reference_shapes_and_init_kinds(arch, size):
    from repro.nn.module import param_count as ref_param_count
    from repro_torch.nn.module import param_count

    ref, port = _modules(arch)
    ref_cfg, cfg = ((ref.SMOKE, port.SMOKE) if size == "smoke"
                    else (ref.CONFIG, port.CONFIG))
    want, got = _flat(RT.model_specs(ref_cfg)), _flat(PT.model_specs(cfg))
    assert list(want) == list(got)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert (got[k].init, got[k].scale) == (want[k].init, want[k].scale), k
    assert param_count(PT.model_specs(cfg)) == ref_param_count(
        RT.model_specs(ref_cfg))
    if size == "full":
        h, kv, hd = HEADS[arch]
        d = cfg.d_model
        assert tuple(got["blocks/pos0/attn/wq"].shape) == (
            cfg.num_layers, d, h, hd)
        assert tuple(got["blocks/pos0/attn/wk"].shape) == (
            cfg.num_layers, d, kv, hd)


# ---------------------------------------------------------------------------
# forward (prefill)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_float32_matches_reference(arch, variant):
    ref_cfg, cfg = _cfgs(arch, variant, dtype="float32")
    params, port = _weights(ref_cfg)
    toks = _tokens(cfg, (2, 40))
    ref, _ = RT.forward(params, jnp.asarray(toks), ref_cfg)
    got, _ = PT.forward(port, torch.from_numpy(toks), cfg)
    assert got.shape == (2, 40, cfg.vocab_size) and got.dtype == torch.float32
    _assert_f32(ref, got)
    assert flash_attention.launches == 0     # CPU tensors never launch


@pytest.mark.usefixtures("kernel_contract_reference")
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bfloat16_matches_the_kernel_contract_reference(
        arch, variant):
    ref_cfg, cfg = _cfgs(arch, variant, dtype="bfloat16")
    params, port = _weights(ref_cfg)
    toks = _tokens(cfg, (2, 40))
    ref, _ = RT.forward(params, jnp.asarray(toks), ref_cfg)
    got, _ = PT.forward(port, torch.from_numpy(toks), cfg)
    assert got.dtype == torch.bfloat16
    _assert_bf16(ref, got)


# ---------------------------------------------------------------------------
# decode


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_float32_matches_reference_at_every_step(arch, variant):
    ref_cfg, cfg = _cfgs(arch, variant, dtype="float32")
    refs, ports = _decode_both(ref_cfg, cfg, steps=16)
    assert decode_attention.launches == 0
    # every position of every step within the bound, the median of the
    # 32 positions within its own
    _assert_f32(np.concatenate(refs, 1), torch.cat(ports, 1))


@pytest.mark.usefixtures("kernel_contract_reference")
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_bfloat16_matches_the_kernel_contract_reference(
        arch, variant):
    ref_cfg, cfg = _cfgs(arch, variant, dtype="bfloat16")
    refs, ports = _decode_both(ref_cfg, cfg, steps=16)
    _assert_bf16(np.concatenate(refs, 1), torch.cat(ports, 1))


def test_deepseek_decodes_mha_one_query_head_per_kv_head(monkeypatch):
    """deepseek-7b's reduced config is MHA (G = 1), as its full config is:
    every decode step's attention reads one query head per kv head."""
    from repro_torch.configs.deepseek_7b import CONFIG, SMOKE
    from repro_torch.models import layers

    assert CONFIG.num_heads == CONFIG.num_kv_heads == 32
    assert SMOKE.num_heads == SMOKE.num_kv_heads == 4
    seen = []

    def spy(q, k_cache, v_cache, lengths, **kw):
        seen.append((q.shape[2], k_cache.shape[2]))
        return decode_attention(q, k_cache, v_cache, lengths, **kw)

    monkeypatch.setattr(layers, "decode_attention", spy)
    ref_cfg, cfg = _cfgs("deepseek-7b", dtype="float32")
    refs, ports = _decode_both(ref_cfg, cfg, steps=6, batch=3)
    assert len(seen) == 6 * cfg.num_layers and set(seen) == {(4, 4)}
    _assert_f32(np.concatenate(refs, 1), torch.cat(ports, 1))


# ---------------------------------------------------------------------------
# generation and the CLI


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_prefill_and_decode_gives_the_reference_tokens(arch, variant):
    from repro.launch.serve import prefill_and_decode as ref_generate
    from repro_torch.launch.serve import prefill_and_decode

    ref_cfg, cfg = _cfgs(arch, variant, dtype="float32")
    params, port = _weights(ref_cfg)
    prompts = _tokens(cfg, (3, 12), seed=2)
    want, _ = ref_generate(ref_cfg, params, jnp.asarray(prompts), max_len=24,
                           new_tokens=12)
    got, _ = prefill_and_decode(cfg, port, torch.from_numpy(prompts),
                                max_len=24, new_tokens=12)
    assert got.dtype == torch.int32 and got.shape == (3, 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_smoke_config_on_the_cpu(arch):
    from repro_torch.launch.serve import main

    buf = io.StringIO()
    with redirect_stdout(buf):
        main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
              "--prompt-len", "4", "--new-tokens", "3"])
    out = buf.getvalue()
    assert "generated shape: (2, 7) on cpu" in out
    assert "decode_tok_s" in out
