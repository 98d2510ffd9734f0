"""The port's vlm and audio families against the JAX package's: the audio
family's musicgen-large (MHA at head dim 64 over a 2,048-token codebook)
and the vlm family's llava-next-mistral-7b (a mistral backbone fed
embeds, GQA 32/8, a 4,096-position sliding window), at their reduced
configs with the reference's weights carried across.

* Configs field-equal to the reference's, full and reduced; spec trees
  with equal shapes and init kinds (llava's has no embedding table), and
  the full parameter counts computed from the specs alone.
* ``forward`` in float32 and bfloat16 against ``repro.models.transformer``
  (llava at S=40 against its reduced window of 16, so the window binds;
  embeds drawn 0.1 N(0, 1) with numpy), ``decode_step`` at every position,
  the port's decode against its own forward (the twin of
  ``tests/test_models.py::test_decode_matches_forward``) and llava's
  rolling cache against the full cache and against the reference's rolling
  decode (the twin of ``tests/test_perf_variants.py``'s).
* ``lm_loss`` and one ``make_train_step`` (C = 2, float32, unfused) with an
  embeds batch (llava) and a token batch (musicgen) against the
  reference's step.
* musicgen through the generation loops: greedy ``prefill_and_decode``,
  the serving CLI and a ``FleetDecoder`` fleet against the reference's
  ``fleet_prefill_and_decode``; llava refused by all of them with a
  ``ValueError`` naming ``make_prefill_step`` / ``make_serve_step``, and
  served through those steps.

Tolerances are ``test_torch_lm_serve.py``'s (its docstring gives the
reasons): float32 every position within 5e-4 of the logit scale and the
median within 1e-5; bfloat16 against the reference with its attention
routed to the kernels' oracles (ROADMAP C3), 95% of positions within
3e-2, all within 1e-1, top-1 equal at >= 95%. The train step is held at
``tests/test_torch_train.py``'s ``LOSS_TOL``, ``PARAM_TOL`` and
``MOM_TOL`` from the reference's weights with wq and wk scaled by 0.1
(ROADMAP C12).
"""
import dataclasses
import importlib
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models import transformer as RT
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import transformer as PT
from test_torch_lm_serve import (  # noqa: F401  (a fixture, used by name)
    _assert_bf16, _assert_f32, _decode_both, _flat, _tokens, _weights,
    kernel_contract_reference,
)

CPU = torch.device("cpu")
ARCHS = {"musicgen-large": "musicgen_large",
         "llava-next-mistral-7b": "llava_next_mistral_7b"}
# the full configs' parameter counts, by the reference's model_specs
PARAMS = {"musicgen-large": 3_229_812_736,
          "llava-next-mistral-7b": 7_110_660_096}
# the full configs' attention: (heads, kv heads, head dim, window)
HEADS = {"musicgen-large": (32, 32, 64, 0),
         "llava-next-mistral-7b": (32, 8, 128, 4096)}
DECODE_FORWARD_TOL = 1e-3     # tests/test_models.py::test_decode_matches_forward
ROLLING_TOL = 1e-4            # tests/test_perf_variants.py's rolling cache
LOSS_ABS_TOL = 1e-5


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
    assert (dataclasses.asdict(reg.get_config(arch))
            == dataclasses.asdict(ref_reg.get_config(arch)))
    assert (dataclasses.asdict(reg.get_smoke_config(arch))
            == dataclasses.asdict(ref_reg.get_smoke_config(arch)))
    cfg = port.CONFIG
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            cfg.sliding_window) == HEADS[arch]
    if arch == "musicgen-large":
        assert (cfg.family, cfg.input_mode) == ("audio", "tokens")
        assert port.SMOKE.num_kv_heads == 4 == port.SMOKE.num_heads
    else:
        assert (cfg.family, cfg.input_mode) == ("vlm", "embeds")
        assert port.SMOKE.sliding_window == 16


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_specs_have_the_reference_shapes_and_init_kinds(arch, size):
    from repro.nn.module import param_count as ref_param_count
    from repro_torch.nn.module import param_count

    ref_mod, port_mod = _modules(arch)
    ref_cfg, cfg = ((ref_mod.SMOKE, port_mod.SMOKE) if size == "smoke"
                    else (ref_mod.CONFIG, port_mod.CONFIG))
    assert PT.block_pattern(cfg) == RT.block_pattern(ref_cfg) == [
        ("attn", "dense")]
    ref, port = _flat(RT.model_specs(ref_cfg)), _flat(PT.model_specs(cfg))
    assert list(ref) == list(port)
    for k in ref:
        assert tuple(port[k].shape) == tuple(ref[k].shape), k
        assert (port[k].init, port[k].scale) == (ref[k].init, ref[k].scale), k
    # llava reads embeds: no embedding table, an unembedding all the same
    assert ("embed/embed" in port) == (arch == "musicgen-large")
    assert "embed/unembed" in port
    n = param_count(PT.model_specs(cfg))
    assert n == ref_param_count(RT.model_specs(ref_cfg))
    if size == "full":
        assert n == PARAMS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_from_numpy_carries_the_reference_tree(arch):
    ref_cfg, cfg = _cfgs(arch)
    params, port = _weights(ref_cfg)
    ref = _flat(jax.tree.map(np.asarray, params))
    got = _flat(port)
    assert list(ref) == list(got) == list(_flat(PT.model_specs(cfg)))
    for k in ref:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(ref[k], got[k].numpy())


# ---------------------------------------------------------------------------
# forward and decode against the reference


# llava at S=40 against its reduced window of 16: the window binds
SEQ = {"musicgen-large": 48, "llava-next-mistral-7b": 40}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_float32_matches_reference(arch):
    ref_cfg, cfg = _cfgs(arch, dtype="float32")
    params, port = _weights(ref_cfg)
    x = _tokens(cfg, (2, SEQ[arch]))
    ref, _ = RT.forward(params, jnp.asarray(x), ref_cfg)
    got, aux = PT.forward(port, torch.from_numpy(x), cfg)
    assert got.shape == (2, SEQ[arch], cfg.vocab_size)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _assert_f32(ref, got)
    if cfg.sliding_window:
        # the window binds: the same model without it reads other logits
        wide = dataclasses.replace(cfg, sliding_window=0)
        full, _ = PT.forward(port, torch.from_numpy(x), wide)
        assert torch.equal(full[:, :cfg.sliding_window],
                           got[:, :cfg.sliding_window])
        assert float((full - got).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bfloat16_matches_the_kernel_contract_reference(
        arch, kernel_contract_reference):
    ref_cfg, cfg = _cfgs(arch, dtype="bfloat16")
    params, port = _weights(ref_cfg)
    x = _tokens(cfg, (2, SEQ[arch]))
    ref, _ = RT.forward(params, jnp.asarray(x), ref_cfg)
    got, _ = PT.forward(port, torch.from_numpy(x), cfg)
    assert got.dtype == torch.bfloat16
    _assert_bf16(ref, got)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_float32_matches_reference_at_every_step(arch):
    ref_cfg, cfg = _cfgs(arch, dtype="float32")
    refs, ports = _decode_both(ref_cfg, cfg, steps=24)
    assert decode_attention.launches == 0
    # every position of every step within the bound, the median over them
    _assert_f32(np.concatenate(refs, 1), torch.cat(ports, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_bfloat16_matches_the_kernel_contract_reference(
        arch, kernel_contract_reference):
    ref_cfg, cfg = _cfgs(arch, dtype="bfloat16")
    refs, ports = _decode_both(ref_cfg, cfg, steps=24)
    _assert_bf16(np.concatenate(refs, 1), torch.cat(ports, 1))


def _port_decode(cfg, port, x, cache_len=None):
    """The port's per-position logits (B, S, V) of ``decode_step`` fed
    ``x``."""
    b, s = x.shape[:2]
    cache = PT.init_cache(cfg, b, cache_len or s, dtype=torch.float32,
                          device=CPU)
    outs = []
    for t in range(s):
        lg, cache = PT.decode_step(port, torch.from_numpy(x[:, t:t + 1]),
                                   cache, t, cfg)
        outs.append(lg)
    return torch.cat(outs, 1), cache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's decode with cache equals its own forward (the twin of
    ``tests/test_models.py::test_decode_matches_forward``), at S=24 so
    llava's reduced window of 16 binds in both."""
    ref_cfg, cfg = _cfgs(arch, dtype="float32")
    _, port = _weights(ref_cfg)
    x = _tokens(cfg, (2, 24), seed=2)
    full, _ = PT.forward(port, torch.from_numpy(x), cfg)
    dec, _ = _port_decode(cfg, port, x)
    rel = float((full - dec).abs().max() / full.abs().max())
    assert rel < DECODE_FORWARD_TOL, rel


def test_llava_rolling_cache_equals_the_full_cache_and_the_reference():
    """The window-sized ring buffer (``layers._attend_cached``) against the
    full cache inside the port and against the reference's rolling decode
    (the twin of ``tests/test_perf_variants.py``'s, window 8 over 24
    positions)."""
    arch = "llava-next-mistral-7b"
    ref_cfg, cfg = _cfgs(arch, dtype="float32", sliding_window=8)
    ref_roll = dataclasses.replace(ref_cfg, rolling_cache=True)
    roll = dataclasses.replace(cfg, rolling_cache=True)
    params, port = _weights(ref_cfg)
    x = _tokens(cfg, (2, 24), seed=2)
    full, _ = _port_decode(cfg, port, x)
    rolled, cache = _port_decode(roll, port, x)
    assert cache["pos0"]["attn"]["k"].shape[2] == cfg.sliding_window
    rel = float((full - rolled).abs().max() / full.abs().max())
    assert rel < ROLLING_TOL, rel
    rcache = RT.init_cache(ref_roll, 2, 24, dtype=jnp.float32)
    refs = []
    for t in range(24):
        lg, rcache = RT.decode_step(params, jnp.asarray(x[:, t:t + 1]),
                                    rcache, jnp.asarray(t), ref_roll)
        refs.append(np.asarray(lg, np.float32))
    _assert_f32(np.concatenate(refs, 1), rolled)


def test_llava_steps_serve_embeds():
    """``make_prefill_step`` and ``make_serve_step`` take (B, S, d) and
    (B, 1, d) embeds, float32 or bfloat16 (the reference's ``lower_prefill``
    and ``lower_serve`` feed bfloat16), and launch nothing on the CPU."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    ref_cfg, cfg = _cfgs("llava-next-mistral-7b", dtype="float32")
    _, port = _weights(ref_cfg)
    x = torch.from_numpy(_tokens(cfg, (2, 20)))
    got = make_prefill_step(cfg)(port, x)
    assert torch.equal(got, PT.forward(port, x, cfg)[0])
    assert torch.equal(make_prefill_step(cfg)(port, x.bfloat16()),
                       PT.forward(port, x.bfloat16().float(), cfg)[0])
    step = make_serve_step(cfg)
    cache = PT.init_cache(cfg, 2, 20, dtype=torch.float32, device=CPU)
    for t in range(20):
        lg, cache = step(port, cache, x[:, t:t + 1], t)
    assert lg.shape == (2, 1, cfg.vocab_size)
    rel = float((lg[:, 0] - got[:, -1]).abs().max() / got.abs().max())
    assert rel < DECODE_FORWARD_TOL, rel
    assert flash_attention.launches == decode_attention.launches == 0


# ---------------------------------------------------------------------------
# training


# a tiny width of each arch's reduced config; llava's window cut to 8 so it
# binds at seq 16, its GQA kept (2 heads over 1)
TRAIN_TINY = {"musicgen-large": dict(num_kv_heads=2),
              "llava-next-mistral-7b": dict(num_kv_heads=1,
                                            sliding_window=8)}


def _train_cfgs(arch):
    kw = dict(num_layers=2, d_model=64, d_ff=128, num_heads=2, head_dim=32,
              vocab_size=128, dtype="float32", **TRAIN_TINY[arch])
    return _cfgs(arch, **kw)


def _train_batch(cfg, lead, seq=16, seed=0):
    """A numpy batch of ``lead`` + (4, seq): int labels, and inputs that are
    the shifted tokens of a token model or embeds of an embeds model."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size,
                        size=lead + (4, seq + 1)).astype(np.int32)
    if cfg.input_mode == "tokens":
        inputs = toks[..., :-1]
    else:
        inputs = (0.1 * rng.standard_normal(lead + (4, seq, cfg.d_model))
                  ).astype(np.float32)
    return {"inputs": inputs, "labels": toks[..., 1:]}


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_the_reference(arch):
    from test_torch_train import _weights as train_weights

    rc, pc = _train_cfgs(arch)
    base = train_weights(rc)
    port = PT.lm_params_from_numpy(base, CPU)
    batch = _train_batch(pc, ())
    want = RT.lm_loss(jax.tree.map(jnp.asarray, base),
                      jax.tree.map(jnp.asarray, batch), rc)
    got = PT.lm_loss(port, {k: torch.from_numpy(v) for k, v in batch.items()},
                     pc)
    assert abs(float(got) - float(want)) <= LOSS_ABS_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch):
    """One pipelined step at C = 2 lanes (float32, unfused), each lane on
    its own batch: an embeds batch of (C, B, S, d) for llava, tokens for
    musicgen; then the cloud sync."""
    from repro.configs.base import TrainConfig as RefTrainConfig
    from repro.launch import mesh as ref_mesh
    from repro.launch import steps as ref_steps
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps as port_steps
    from test_torch_train import (
        LOSS_TOL, _assert_state, _stacked_state, _to_torch,
    )
    from test_torch_train import _weights as train_weights

    rc, pc = _train_cfgs(arch)
    kw = dict(learning_rate=0.1, momentum=0.5, fused_sgd=False)
    ref_step, ref_sync = ref_steps.make_train_step(
        rc, RefTrainConfig(**kw), ref_mesh.make_host_mesh())
    port_step, port_sync = port_steps.make_train_step(pc, TrainConfig(**kw))
    state = _stacked_state(train_weights(rc), 2)
    rs = jax.tree.map(jnp.asarray, state)
    ps = port_steps.train_state_from_numpy(state, CPU)
    batch = _train_batch(pc, (2,))
    rs, rl = jax.jit(ref_step)(rs, jax.tree.map(jnp.asarray, batch))
    ps, pl = port_step(ps, _to_torch(batch))
    assert abs(float(pl) - float(rl)) <= LOSS_TOL
    _assert_state(rs, ps, pc)
    _assert_state(jax.jit(ref_sync)(rs), port_sync(ps), pc, mom_zero=True)


# ---------------------------------------------------------------------------
# the generation loops: musicgen serves, llava is refused


def test_musicgen_greedy_prefill_and_decode_gives_the_reference_tokens():
    from repro.launch.serve import prefill_and_decode as ref_generate
    from repro_torch.launch.serve import prefill_and_decode

    ref_cfg, cfg = _cfgs("musicgen-large", dtype="float32")
    params, port = _weights(ref_cfg)
    prompts = _tokens(cfg, (3, 12), seed=2)
    want, _ = ref_generate(ref_cfg, params, jnp.asarray(prompts), max_len=28,
                           new_tokens=16)
    got, _ = prefill_and_decode(cfg, port, torch.from_numpy(prompts),
                                max_len=28, new_tokens=16)
    assert got.dtype == torch.int32 and got.shape == (3, 28)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_cli_runs_musicgen_smoke_on_the_cpu():
    from repro_torch.launch.serve import main

    buf = io.StringIO()
    with redirect_stdout(buf):
        main(["--arch", "musicgen-large", "--smoke", "--device", "cpu",
              "--batch", "2", "--prompt-len", "4", "--new-tokens", "3"])
    out = buf.getvalue()
    assert "generated shape: (2, 7) on cpu" in out
    assert "decode_tok_s" in out


FLEET_K, FLEET_B, FLEET_S0, FLEET_N = 3, 4, 8, 6


def test_musicgen_fleet_matches_the_reference():
    """K = 3 musicgen models of the reduced config drawn by the reference,
    B = 4 requests over them: the greedy tokens equal the reference's
    ``fleet_prefill_and_decode``, the dispatch counts equal, and the port's
    tokens equal its per-model loop's."""
    from repro.serve.fleet import FleetParams as RefParams
    from repro.serve.fleet import fleet_prefill_and_decode as ref_generate
    from repro_torch.serve.fleet import (
        FleetParams, fleet_prefill_and_decode, loop_prefill_and_decode,
    )

    ref_cfg, cfg = _cfgs("musicgen-large", dtype="float32")
    trees = [jax.tree.map(np.asarray, RT.init_model(jax.random.PRNGKey(i),
                                                    ref_cfg))
             for i in range(FLEET_K)]
    lanes = np.array([2, 0, 2, 1])
    prompts = _tokens(cfg, (FLEET_B, FLEET_S0), seed=3)
    kw = dict(max_len=FLEET_S0 + FLEET_N, new_tokens=FLEET_N)
    want, ref_stats = ref_generate(ref_cfg, RefParams.from_trees(trees),
                                   lanes, jnp.asarray(prompts), **kw)
    fleet = FleetParams(jax.tree.map(lambda *xs: np.stack(xs), *trees), True,
                        device=CPU)
    got, stats = fleet_prefill_and_decode(cfg, fleet, lanes, prompts, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for key in ("prefill_dispatches", "decode_dispatches_per_step",
                "distinct_models"):
        assert stats[key] == ref_stats[key], key
    loop, _ = loop_prefill_and_decode(cfg, fleet, lanes, prompts, **kw)
    assert torch.equal(got, loop)


LOOPS = ("prefill_and_decode", "cli", "cli_fleet", "fleet_decoder")


@pytest.mark.parametrize("loop", LOOPS)
def test_llava_is_refused_by_the_generation_loops(loop, monkeypatch):
    """The loops feed argmax tokens back, which an embeds model cannot
    take: each raises ``ValueError`` naming the steps that serve it. The
    CLI raises on the full config before any weights are drawn."""
    import repro_torch.launch.serve as serve
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.serve.fleet import FleetDecoder

    def no_draw(*a, **k):
        raise AssertionError("weights drawn before the check")

    monkeypatch.setattr(serve, "init_model", no_draw)
    monkeypatch.setattr(serve, "draw_fleet", no_draw)
    cfg = get_smoke_config("llava-next-mistral-7b")
    calls = {
        "prefill_and_decode": lambda: serve.prefill_and_decode(
            cfg, {}, torch.zeros((1, 2), dtype=torch.int32), max_len=4,
            new_tokens=2),
        "cli": lambda: serve.main(["--arch", "llava-next-mistral-7b",
                                   "--device", "cpu"]),
        "cli_fleet": lambda: serve.main(["--arch", "llava-next-mistral-7b",
                                         "--device", "cpu", "--fleet", "2"]),
        "fleet_decoder": lambda: FleetDecoder(cfg),
    }
    with pytest.raises(ValueError, match="make_prefill_step and "
                       "make_serve_step"):
        calls[loop]()
