"""The port's hybrid family against the JAX package's: jamba-v0.1-52b
(Mamba2 and attention layers, MoE FFNs on the odd positions), at its
reduced config and at the real period-8 pattern cut to smoke widths, with
the reference's weights carried across (``lm_params_from_numpy``).

* Configs: ``CONFIG``, ``SMOKE``, the registry's ``get_config``,
  ``get_smoke_config`` and ``all_configs`` equal the reference's field by
  field; ``block_pattern`` and ``num_repeats`` too; the spec trees have the
  reference's names, shapes and init kinds, and the parameter counts the
  card's paths name.
* ``forward`` (logits and the MoE aux loss), ``make_prefill_step``,
  ``decode_step`` at every position with its attention and SSM caches,
  greedy ``prefill_and_decode`` and ``lm_loss``, in float32; ``forward``
  and ``decode_step`` in bfloat16 against the reference with its
  attention routed to the kernels' oracles (ROADMAP C3; the SSD scan's
  contract, C4, is the reference's default ``ssd_intra_dtype``), with wq
  and wk scaled by 0.1 (C12, below).
* The port's decode against its own forward at the reference's 3e-2
  (``tests/test_models.py``: a prefill's capacity pool and a decode step's
  B tokens drop differently), and 1e-3 at a capacity that drops nothing.
* What still raises: training (its Mamba2 layers need the SSD scan's
  backward, ROADMAP A10.5) and fleet decoding (its MoE layers,
  A10.4b-fleet).

Tolerances: ``tests/test_torch_lm_serve.py``'s (its docstring gives the
reasons): float32 logits within 5e-4 of the logit scale at every position
and 1e-5 at the median. The aux loss within 1e-6 (``test_torch_moe.py``),
the caches within 1e-4 of their scale in float32.

bfloat16. The two packages round the same values to bfloat16 at the same
places, but not always to the same bits: XLA's SiLU on bfloat16 differs
from PyTorch's in about a third of the FFN's activations by an ulp, and the
projections sum in another order. A Mamba2 layer passes those ulps on, and
at the reference's initial scale (``fan_in`` reads ``shape[-2]``, so
attention scores are near one-hot, ROADMAP C12) an attention layer after
it turns them into other picks: with the reference's weights as drawn,
15% of the reduced model's positions land outside 3e-2 in bfloat16. So
the bfloat16 cases scale wq and wk by 0.1, as the training parity tests
do, and hold two things:
* each package's bfloat16 logits against the reference's float32 ones:
  the port's median error no more than ``BF16_OWN`` (1.25x) the
  reference's own, and its top-1 agreement with float32 at most
  ``BF16_TOP1_SLACK`` (5 points) below the reference's. This is what holds
  the 8-layer pattern: at smoke widths its seven Mamba2 layers carry the
  ulps so far that the reference's own bfloat16 logits lie 0.13-0.24 of
  the logit scale from its float32 ones at the worst position, the port's
  as far, at other positions from one draw to the next (so the tails are
  not compared); the medians agree within 8% over two draws;
* at the reduced config, the port against the reference directly at
  ``test_torch_lm_serve.py``'s bfloat16 bounds: 95% of positions within
  3e-2, all within 1e-1, top-1 equal at 95%.
"""
import dataclasses
import functools
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import torch_parity  # noqa: F401  (one torch thread in each test worker)

from repro.configs.jamba_v0_1_52b import CONFIG as REF_CONFIG
from repro.configs.jamba_v0_1_52b import SMOKE as REF_SMOKE
from repro.models import transformer as RT
from repro_torch.configs.jamba_v0_1_52b import CONFIG, SMOKE
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models import transformer as PT
from test_torch_lm_serve import (  # noqa: F401  (a fixture, used by name)
    _assert_bf16, _assert_f32, _flat, _rel_err, _tokens, _weights,
    kernel_contract_reference,
)

CPU = torch.device("cpu")
ARCH = "jamba-v0.1-52b"
# the real pattern cut to smoke widths: 7 Mamba2 layers and one attention
# layer at position 4, experts at the odd positions
PERIOD8 = {"num_layers": 8, "attn_every": 8, "attn_offset": 4}
VARIANTS = {"smoke": {}, "period8": PERIOD8}
AUX_TOL, CACHE_TOL = 1e-6, 1e-4
DECODE_FORWARD_TOL = 3e-2        # tests/test_models.py, jamba's row
DENSE_DECODE_FORWARD_TOL = 1e-3  # the same test's rows without drops
QK_SCALE = 0.1                   # ROADMAP C12, as tests/test_torch_train.py
# bfloat16: the port's median error against the float32 reference over the
# reference's own, and the top-1 agreement with float32 it may lose
BF16_OWN, BF16_TOP1_SLACK = 1.25, 0.05
# parameter counts by the reference's model_specs: the whole model, and the
# two cuts the card runs (chip_smoke.py phases 4e and 5e)
PARAMS = {"full": 51_460_000_640, "2 layers": 3_675_001_376,
          "8 layers": 13_267_656_416}


def _cfgs(variant="smoke", **kw):
    kw = {**VARIANTS[variant], **kw}
    return (dataclasses.replace(REF_SMOKE, **kw),
            dataclasses.replace(SMOKE, **kw))


def _cut(cfg, layers):
    """jamba's published widths at ``layers`` layers: 2 layers run the
    reduced config's pattern, 8 one period of the real one."""
    if layers == 2:
        return dataclasses.replace(cfg, num_layers=2, attn_every=2,
                                   attn_offset=1, moe_every=2, moe_offset=1)
    return dataclasses.replace(cfg, num_layers=layers)


# ---------------------------------------------------------------------------
# configs, patterns, specs


def test_configs_equal_the_reference_and_resolve_in_the_registry():
    from repro.configs import registry as ref_reg
    from repro_torch.configs import registry as reg

    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(REF_CONFIG)
    assert dataclasses.asdict(SMOKE) == dataclasses.asdict(REF_SMOKE)
    for fn, ref_fn in ((reg.get_config, ref_reg.get_config),
                       (reg.get_smoke_config, ref_reg.get_smoke_config)):
        assert dataclasses.asdict(fn(ARCH)) == dataclasses.asdict(ref_fn(ARCH))
    assert (CONFIG.family, CONFIG.ssm_state, CONFIG.ssm_chunk) == (
        "hybrid", 16, 128)


def test_all_configs_equal_the_reference():
    from repro.configs import registry as ref_reg
    from repro_torch.configs import registry as reg

    port, ref = reg.all_configs(), ref_reg.all_configs()
    assert list(port) == list(ref) == list(ref_reg.ARCH_IDS)
    for arch in ref:
        assert dataclasses.asdict(port[arch]) == dataclasses.asdict(ref[arch])


@pytest.mark.parametrize("variant", ["full", "smoke", "period8", "2 layers"])
def test_block_pattern_and_repeats_equal_the_reference(variant):
    if variant == "full":
        ref_cfg, cfg = REF_CONFIG, CONFIG
    elif variant == "2 layers":
        ref_cfg, cfg = _cut(REF_CONFIG, 2), _cut(CONFIG, 2)
    else:
        ref_cfg, cfg = _cfgs(variant)
    pattern = PT.block_pattern(cfg)
    assert pattern == RT.block_pattern(ref_cfg)
    assert PT.num_repeats(cfg) == RT.num_repeats(ref_cfg)
    if variant in ("full", "period8"):
        assert pattern == [("ssm", "dense"), ("ssm", "moe"), ("ssm", "dense"),
                           ("ssm", "moe"), ("attn", "dense"), ("ssm", "moe"),
                           ("ssm", "dense"), ("ssm", "moe")]
        assert PT.num_repeats(cfg) == (4 if variant == "full" else 1)
    else:
        assert pattern == [("ssm", "dense"), ("attn", "moe")]


@pytest.mark.parametrize("size", ["smoke", "period8", "full", "2 layers",
                                  "8 layers"])
def test_model_specs_have_the_reference_shapes_and_init_kinds(size):
    from repro.nn.module import param_count as ref_param_count
    from repro_torch.models.registry import specs_for
    from repro_torch.nn.module import param_count

    if size in ("smoke", "period8"):
        ref_cfg, cfg = _cfgs(size)
    elif size == "full":
        ref_cfg, cfg = REF_CONFIG, CONFIG
    else:
        n = int(size.split()[0])
        ref_cfg, cfg = _cut(REF_CONFIG, n), _cut(CONFIG, n)
    ref, port = _flat(RT.model_specs(ref_cfg)), _flat(specs_for(cfg))
    assert list(ref) == list(port)
    for k in ref:
        assert tuple(port[k].shape) == tuple(ref[k].shape), k
        assert (port[k].init, port[k].scale) == (ref[k].init, ref[k].scale), k
    n = param_count(specs_for(cfg))
    assert n == ref_param_count(RT.model_specs(ref_cfg))
    if size in PARAMS:
        assert n == PARAMS[size]


@pytest.mark.parametrize("variant", VARIANTS)
def test_caches_have_the_reference_shapes(variant):
    ref_cfg, cfg = _cfgs(variant)
    ref = _flat(RT.cache_specs(ref_cfg, 3, 20, dtype=jnp.bfloat16))
    port = _flat(PT.cache_specs(cfg, 3, 20, dtype=torch.bfloat16))
    assert list(ref) == list(port)
    for k in ref:
        assert tuple(port[k].shape) == tuple(ref[k].shape), k
        # K and V in the asked dtype, the Mamba2 caches float32 always
        want = torch.bfloat16 if "/attn/" in k else torch.float32
        assert port[k].dtype == want, k


def test_lm_params_from_numpy_keeps_the_hybrid_tree():
    params, port = _weights(REF_SMOKE)
    ref, got = _flat(jax.tree.map(np.asarray, params)), _flat(port)
    assert list(ref) == list(got) == list(_flat(PT.model_specs(SMOKE)))
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k].numpy())


# ---------------------------------------------------------------------------
# forward (prefill) and loss


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_float32_matches_the_reference(variant):
    """40 positions: a ragged last chunk at the reduced chunk of 32."""
    ref_cfg, cfg = _cfgs(variant, dtype="float32")
    params, port = _weights(ref_cfg)
    toks = _tokens(cfg, (2, 40))
    ref, ref_aux = RT.forward(params, jnp.asarray(toks), ref_cfg)
    got, aux = PT.forward(port, torch.from_numpy(toks), cfg)
    assert got.shape == (2, 40, cfg.vocab_size) and got.dtype == torch.float32
    _assert_f32(ref, got)
    # one MoE term a MoE layer, each near router_aux_coef (0.01)
    moe_layers = sum(f == "moe" for _, f in PT.block_pattern(cfg)) * (
        PT.num_repeats(cfg))
    assert float(aux) > 0.005 * moe_layers
    assert abs(float(aux) - float(ref_aux)) <= AUX_TOL


def _scaled_weights(ref_cfg, seed=0):
    """``_weights`` with every attention layer's wq and wk scaled by
    ``QK_SCALE``."""
    params = jax.tree.map(np.asarray, RT.init_model(
        jax.random.PRNGKey(seed), dataclasses.replace(ref_cfg,
                                                      dtype="float32")))
    for entry in params["blocks"].values():
        for w in ("wq", "wk"):
            if "attn" in entry:
                entry["attn"][w] = entry["attn"][w] * np.float32(QK_SCALE)
    return (jax.tree.map(jnp.asarray, params),
            PT.lm_params_from_numpy(params, CPU))


def _assert_bf16_as_the_reference(truth, ref, got):
    """The port's bfloat16 logits ``got`` no farther from the reference's
    float32 ``truth`` than the reference's own bfloat16 ``ref`` are, within
    ``BF16_OWN`` (see the module docstring)."""
    truth = np.asarray(truth, np.float32)
    own = np.median(_rel_err(truth, np.asarray(ref, np.float32)))
    port = np.median(_rel_err(truth, got.float().numpy()))
    assert port <= BF16_OWN * own, (port, own)
    top1 = truth.argmax(-1)
    own_top1 = np.mean(top1 == np.asarray(ref, np.float32).argmax(-1))
    port_top1 = np.mean(top1 == got.float().numpy().argmax(-1))
    assert port_top1 >= own_top1 - BF16_TOP1_SLACK, (port_top1, own_top1)


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_bfloat16_matches_the_kernel_contract_reference(
        variant, kernel_contract_reference):
    ref_cfg, cfg = _cfgs(variant, dtype="bfloat16")
    params, port = _scaled_weights(ref_cfg)
    toks = jnp.asarray(_tokens(cfg, (2, 40)))
    truth, _ = RT.forward(params, toks,
                          dataclasses.replace(ref_cfg, dtype="float32"))
    ref, _ = RT.forward(params, toks, ref_cfg)
    got, _ = PT.forward(port, torch.from_numpy(np.array(toks)), cfg)
    assert got.dtype == torch.bfloat16
    _assert_bf16_as_the_reference(truth, ref, got)
    if variant == "smoke":
        _assert_bf16(ref, got)


def test_prefill_step_is_forward_and_never_launches_on_the_cpu():
    from repro_torch.launch.steps import make_prefill_step

    ref_cfg, cfg = _cfgs(dtype="float32")
    _, port = _weights(ref_cfg)
    toks = torch.from_numpy(_tokens(cfg, (1, 16)))
    before = (flash_attention.launches, ssd_scan.launches)
    got = make_prefill_step(cfg)(port, toks)
    assert torch.equal(got, PT.forward(port, toks, cfg)[0])
    assert (flash_attention.launches, ssd_scan.launches) == before == (0, 0)


@pytest.mark.parametrize("variant", VARIANTS)
def test_lm_loss_with_the_aux_term_matches_the_reference(variant):
    ref_cfg, cfg = _cfgs(variant, dtype="float32")
    params, port = _weights(ref_cfg)
    toks = _tokens(cfg, (2, 33), seed=3)
    mask = (np.random.default_rng(4).random((2, 32)) < 0.8).astype(
        np.float32)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
    ref = float(RT.lm_loss(params, jax.tree.map(jnp.asarray, batch), ref_cfg))
    got = PT.lm_loss(port, {k: torch.from_numpy(v) for k, v in batch.items()},
                     cfg)
    assert got.dtype == torch.float32
    _, aux = PT.forward(port, torch.from_numpy(batch["inputs"]), cfg)
    assert float(aux) > 0                  # the loss carries the aux term
    assert abs(float(got) - ref) <= 1e-5 * max(1.0, abs(ref)), (float(got),
                                                                 ref)


# ---------------------------------------------------------------------------
# decode


def _decode_both(ref_cfg, cfg, steps, batch=2, weights=_weights):
    """Feed the same tokens position by position through both packages'
    ``decode_step``; returns the per-step logits and the final caches."""
    from repro_torch.launch.steps import make_serve_step

    params, port = weights(ref_cfg)
    toks = _tokens(cfg, (batch, steps), seed=1)
    rcache = RT.init_cache(ref_cfg, batch, steps, dtype=jnp.float32)
    pcache = PT.init_cache(cfg, batch, steps, dtype=torch.float32,
                           device=CPU)
    rstep = jax.jit(lambda p, t, c, i: RT.decode_step(p, t, c, i, ref_cfg))
    pstep = make_serve_step(cfg)
    refs, ports = [], []
    for i in range(steps):
        rl, rcache = rstep(params, jnp.asarray(toks[:, i:i + 1]), rcache,
                           jnp.asarray(i))
        pl, same = pstep(port, pcache, torch.from_numpy(toks[:, i:i + 1]), i)
        assert same is pcache and pl.shape == (batch, 1, cfg.vocab_size)
        refs.append(np.asarray(rl, np.float32))
        ports.append(pl)
    return (np.concatenate(refs, 1), torch.cat(ports, 1),
            _flat(jax.tree.map(np.asarray, rcache)), _flat(pcache))


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_step_float32_matches_the_reference_with_its_caches(variant):
    ref_cfg, cfg = _cfgs(variant, dtype="float32")
    before = (flash_attention.launches, decode_attention.launches,
              ssd_scan.launches)
    ref, got, rcache, pcache = _decode_both(ref_cfg, cfg, steps=16)
    _assert_f32(ref, got)
    assert list(rcache) == list(pcache)
    assert any("/ssm/" in k for k in pcache) and any(
        "/attn/" in k for k in pcache)
    for k, r in rcache.items():
        p = pcache[k].numpy()
        assert p.shape == r.shape
        assert np.abs(p - r).max() <= CACHE_TOL * max(1.0, np.abs(r).max()), k
    assert (flash_attention.launches, decode_attention.launches,
            ssd_scan.launches) == before == (0, 0, 0)


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_step_bfloat16_matches_the_kernel_contract_reference(
        variant, kernel_contract_reference):
    ref_cfg, cfg = _cfgs(variant, dtype="bfloat16")
    ref, got, _, _ = _decode_both(ref_cfg, cfg, steps=16, batch=4,
                                  weights=_scaled_weights)
    truth, _, _, _ = _decode_both(*_cfgs(variant, dtype="float32"), steps=16,
                                  batch=4, weights=_scaled_weights)
    _assert_bf16_as_the_reference(truth, ref, got)
    if variant == "smoke":
        _assert_bf16(ref, got)


@pytest.mark.parametrize("variant,capacity_factor,tol", [
    ("smoke", 1.25, DECODE_FORWARD_TOL), ("smoke", 8.0, DENSE_DECODE_FORWARD_TOL),
    ("period8", 1.25, DECODE_FORWARD_TOL)])
def test_decode_matches_forward(variant, capacity_factor, tol):
    """The port's decode with cache (the Mamba2 recurrence, decode
    attention) against its own forward (the chunked scan, flash
    attention)."""
    ref_cfg, cfg = _cfgs(variant, dtype="float32",
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


@pytest.mark.parametrize("variant", VARIANTS)
def test_greedy_prefill_and_decode_gives_the_reference_tokens(variant):
    """The reference's ``_prefill`` feeds the prompt through
    ``decode_step``, so the port's runs no SSD scan and no flash attention
    (on the card: one decode-attention launch a position an attention
    layer)."""
    from repro.launch.serve import prefill_and_decode as ref_generate
    from repro_torch.launch.serve import prefill_and_decode

    ref_cfg, cfg = _cfgs(variant, dtype="float32")
    params, port = _weights(ref_cfg)
    prompts = _tokens(cfg, (3, 12), seed=2)
    want, _ = ref_generate(ref_cfg, params, jnp.asarray(prompts), max_len=28,
                           new_tokens=16)
    got, stats = prefill_and_decode(cfg, port, torch.from_numpy(prompts),
                                    max_len=28, new_tokens=16)
    assert got.dtype == torch.int32 and got.shape == (3, 28)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(stats) == {"prefill_s", "decode_s", "decode_tok_s"}
    assert ssd_scan.launches == flash_attention.launches == 0


# ---------------------------------------------------------------------------
# chip_smoke.py's hybrid path: its bfloat16 pre-cast and launch counts


@functools.cache
def _smoke():
    """``chip_smoke.py`` as a module (it runs nothing on import)."""
    import importlib.util
    import sys
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = smoke         # its dataclass looks itself up
    try:
        spec.loader.exec_module(smoke)
    finally:
        del sys.modules[spec.name]
    return smoke


@pytest.mark.parametrize("arch", [ARCH, "mamba2-2.7b"])
def test_cast_matrices_keeps_the_bfloat16_bits(arch):
    """The card's CPU references run bfloat16 from ``cast_matrices``' copy:
    the norms and the Mamba2 leaves read through ``.float()`` stay
    float32, so ``cast_bit_check`` finds the prefill logits and the greedy
    tokens equal to the float32 weights' runs bit for bit."""
    from repro_torch.configs.registry import get_smoke_config

    smoke = _smoke()
    cfg = get_smoke_config(arch)
    params = PT.init_model(torch.Generator().manual_seed(0), cfg, CPU)
    cast = _flat(smoke.cast_matrices(params, torch.bfloat16))
    assert {k for k, v in cast.items() if v.dtype == torch.float32} == {
        k for k in cast if k.rsplit("/", 1)[1] in smoke.FLOAT_LEAVES
        or k.endswith("norm")}
    assert cast["blocks/pos0/ssm/in_proj"].dtype == torch.bfloat16
    before = len(smoke.FAILURES)
    smoke.cast_bit_check(cfg)
    assert len(smoke.FAILURES) == before


def test_chip_smoke_hybrid_path_counts_the_reference_launches():
    """Phase 4e's 2 layers: one flash and one scan a prefill, 24 decode
    launches over 16 + 8 positions; phase 5e's period: one flash and seven
    scans a prefill, 48 decode launches over 16 + 32, and no scan in a
    serving run (the prompt goes through ``decode_step``)."""
    smoke = _smoke()
    two = smoke.hybrid_path(dataclasses.replace(CONFIG, **smoke.HYBRID_TWO))
    deep = dataclasses.replace(CONFIG, num_layers=smoke.HYBRID_DEEP_LAYERS)
    assert two.prefill_launches(two.cfg) == {
        "flash_attention": 1, "decode_attention": 0, "ssd_scan": 1}
    assert two.serve_launches(two.cfg, 24) == {
        "flash_attention": 0, "decode_attention": 24, "ssd_scan": 0}
    assert two.prefill_launches(deep) == {
        "flash_attention": 1, "decode_attention": 0, "ssd_scan": 7}
    assert two.serve_launches(deep, 48) == {
        "flash_attention": 0, "decode_attention": 48, "ssd_scan": 0}
    # both controls held in float32; in bfloat16 the wq one is logged (its
    # move lies below bfloat16's rounding, chip_smoke.HYBRID_GPU_VS_CPU)
    for dtype, held in (("float32", [True, True]),
                        ("bfloat16", [False, True])):
        controls = smoke.path_controls(two, dtype)
        assert [c[0] for c in controls] == ["wq x1.03", "ssm in_proj x1.03"]
        assert [c[2] for c in controls] == held


# ---------------------------------------------------------------------------
# what still raises, the entry point, imports


def test_training_raises_naming_a10_5():
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.steps import make_train_step

    for cfg in (SMOKE, dataclasses.replace(SMOKE, **PERIOD8), CONFIG):
        with pytest.raises(NotImplementedError, match="ROADMAP A10.5"):
            make_train_step(cfg, TrainConfig())


def test_the_hybrid_fleet_decoder_raises_naming_a10_4b_fleet():
    from repro_torch.serve.fleet import FleetDecoder

    with pytest.raises(NotImplementedError, match="ROADMAP A10.4b-fleet"):
        FleetDecoder(SMOKE)
    with pytest.raises(NotImplementedError, match="ROADMAP A10.4b-fleet"):
        PT.decode_step_lanes({}, torch.zeros(1, dtype=torch.long),
                             torch.zeros(1, 1, dtype=torch.int32), {}, 0,
                             SMOKE)


def test_serve_cli_serves_jamba_smoke_on_the_cpu():
    from repro_torch.launch.serve import main

    buf = io.StringIO()
    with redirect_stdout(buf):
        main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
              "--prompt-len", "4", "--new-tokens", "3"])
    out = buf.getvalue()
    assert "generated shape: (2, 7) on cpu" in out
    assert "decode_tok_s" in out


def test_importing_the_hybrid_path_leaves_jax_unloaded():
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    mods = ["repro_torch.configs.jamba_v0_1_52b", "repro_torch.models.transformer",
            "repro_torch.launch.serve"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
