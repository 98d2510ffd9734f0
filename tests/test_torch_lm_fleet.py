"""The port's LM fleet serving (``repro_torch.serve.fleet``: ``FleetDecoder``,
``fleet_prefill_and_decode``, ``loop_prefill_and_decode``;
``launch/serve.py --fleet``) against the JAX package's, at
``tests/test_serve_fleet.py``'s sizes: K = 5 models of a reduced config
drawn by the reference (``init_model(PRNGKey(i))``) and carried in as the
reference's stacked numpy tree, B = 6 requests, prompts of 8, 6 new tokens.

* Against the reference, for yi-9b, stablelm-12b, deepseek-7b and
  mamba2-2.7b: greedy fleet tokens equal the reference's
  ``fleet_prefill_and_decode`` in float32, and both packages' fleet decode
  steps fed the same tokens give logits within ``test_torch_lm_serve.py``'s
  float32 bounds; in bfloat16 within its bfloat16 bounds of the reference
  with its attention routed to the kernels' oracles (ROADMAP C3).
* Inside the port, the reference's contracts: fleet tokens equal the
  per-model loop's and each request's solo ``prefill_and_decode`` of its
  own model; one dispatch for prefill and one a decode step whatever the
  batch spans; host-resident serving bit-equal to device-resident, with
  and without ``prefetch``; seeded temperature runs repeat.
* The lane-stacked decode step against ``decode_step`` of each request's
  model, including a sliding window, a rolling cache and tied embeddings.

Tolerances are ``test_torch_lm_serve.py``'s, imported from it, for the same
reasons (its docstring): float32 every position within 5e-4 of the logit
scale and the median within 1e-5; bfloat16 95% of positions within 3e-2,
all within 1e-1, top-1 equal at >= 95%. The lane-stacked step differs from
``decode_step`` only in batched against single matrix products: 1e-5 of
the logit scale.
"""
import dataclasses
import functools
import io
import re
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.registry import get_smoke_config as ref_smoke
from repro.models import transformer as RT
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.models import transformer as PT
from test_torch_lm_serve import (  # noqa: F401  (a fixture, used by name)
    _assert_bf16, _assert_f32, _rel_err, kernel_contract_reference,
)

K, B, S0, N = 5, 6, 8, 6
CPU = torch.device("cpu")
ARCHS = ("yi-9b", "stablelm-12b", "deepseek-7b", "mamba2-2.7b")
LANES_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """The reference's K models of ``arch``'s reduced config (float32
    draws, as numpy trees), the batch's lanes and prompts."""
    ref_cfg = dataclasses.replace(ref_smoke(arch), dtype="float32")
    trees = [jax.tree.map(np.asarray, RT.init_model(jax.random.PRNGKey(i),
                                                    ref_cfg))
             for i in range(K)]
    rng = np.random.default_rng(0)
    lanes = rng.integers(0, K, size=B)
    assert len(np.unique(lanes)) > 1     # the batch must span models
    prompts = rng.integers(0, ref_cfg.vocab_size, size=(B, S0)).astype(
        np.int32)
    return trees, lanes, prompts


def _cfgs(arch, dtype):
    return (dataclasses.replace(ref_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype))


def _stacked(trees):
    """The reference's stacked fleet tree, as numpy."""
    return jax.tree.map(lambda *xs: np.stack(xs), *trees)


def _fleet(trees, resident=True):
    from repro_torch.serve.fleet import FleetParams
    return FleetParams(_stacked(trees), resident, device=CPU)


def _gen(cfg, fleet, lanes, prompts, **kw):
    from repro_torch.serve.fleet import fleet_prefill_and_decode
    return fleet_prefill_and_decode(cfg, fleet, lanes, prompts,
                                    max_len=S0 + N, new_tokens=N, **kw)


def _ref_teacher_forced(ref_cfg, trees, lanes, toks):
    """Per-position logits (B, S, V) of the reference's fleet decode step
    fed ``toks``."""
    from repro.serve.fleet import FleetDecoder, FleetParams

    stack, local = FleetParams.from_trees(trees).rows(lanes)
    dec = FleetDecoder(ref_cfg)
    cache = dec.new_cache(len(lanes), toks.shape[1])
    out = []
    for i in range(toks.shape[1]):
        logits, cache = dec.decode_step(stack, local, jnp.asarray(toks[:, i]),
                                        cache, jnp.asarray(i))
        out.append(np.asarray(logits, np.float32))
    return np.stack(out, 1)


def _teacher_forced(cfg, fleet, lanes, toks):
    """The same through the port's ``FleetDecoder``."""
    from repro_torch.serve.fleet import FleetDecoder

    dec = FleetDecoder(cfg)
    stack, local = fleet.rows(lanes)
    tree = fleet.tree(stack)
    cache = dec.new_cache(len(lanes), toks.shape[1], device=CPU)
    out = []
    for i in range(toks.shape[1]):
        logits, cache = dec.decode_step(tree, local,
                                        torch.from_numpy(toks[:, i]), cache, i)
        out.append(logits)
    assert dec.dispatches == toks.shape[1]
    return torch.stack(out, 1)


# ---------------------------------------------------------------------------
# against the reference


@pytest.mark.parametrize("arch", ARCHS)
def test_fleet_tokens_equal_the_reference_in_float32(arch):
    from repro.serve.fleet import FleetParams as RefParams
    from repro.serve.fleet import fleet_prefill_and_decode as ref_generate

    ref_cfg, cfg = _cfgs(arch, "float32")
    trees, lanes, prompts = _setup(arch)
    want, ref_stats = ref_generate(ref_cfg, RefParams.from_trees(trees), lanes,
                                   jnp.asarray(prompts), max_len=S0 + N,
                                   new_tokens=N)
    got, stats = _gen(cfg, _fleet(trees), lanes, prompts)
    assert got.dtype == torch.int32 and got.shape == (B, S0 + N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(stats) == set(ref_stats)
    for key in ("prefill_dispatches", "decode_dispatches_per_step",
                "distinct_models"):
        assert stats[key] == ref_stats[key], key
    toks = np.array(want)
    _assert_f32(_ref_teacher_forced(ref_cfg, trees, lanes, toks),
                _teacher_forced(cfg, _fleet(trees), lanes, toks))


@pytest.mark.usefixtures("kernel_contract_reference")
@pytest.mark.parametrize("arch", ARCHS)
def test_fleet_logits_bfloat16_match_the_kernel_contract_reference(arch):
    ref_cfg, cfg = _cfgs(arch, "bfloat16")
    trees, lanes, prompts = _setup(arch)
    toks, _ = _gen(dataclasses.replace(cfg, dtype="float32"), _fleet(trees),
                   lanes, prompts)
    toks = toks.numpy()
    got = _teacher_forced(cfg, _fleet(trees), lanes, toks)
    assert got.dtype == torch.bfloat16
    _assert_bf16(_ref_teacher_forced(ref_cfg, trees, lanes, toks), got)


# ---------------------------------------------------------------------------
# the reference's contracts, inside the port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fleet_equals_the_loop_and_each_solo_run(arch, dtype):
    from repro_torch.launch.serve import prefill_and_decode
    from repro_torch.serve.fleet import loop_prefill_and_decode

    _, cfg = _cfgs(arch, dtype)
    trees, lanes, prompts = _setup(arch)
    fleet = _fleet(trees)
    toks, _ = _gen(cfg, fleet, lanes, prompts)
    loop, loop_stats = loop_prefill_and_decode(
        cfg, fleet, lanes, prompts, max_len=S0 + N, new_tokens=N)
    assert torch.equal(toks, loop)
    assert set(loop_stats) == {"total_s", "requests_s", "distinct_models"}
    assert loop_stats["distinct_models"] == len(np.unique(lanes))
    # every request, decoded alone under its own client's model, gives its
    # row of the fleet's output
    for b in range(B):
        solo, _ = prefill_and_decode(
            cfg, PT.lm_params_from_numpy(trees[int(lanes[b])], CPU),
            torch.from_numpy(prompts[b:b + 1]), max_len=S0 + N, new_tokens=N)
        assert torch.equal(toks[b], solo[0]), b


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-2.7b"])
def test_decode_is_one_dispatch_a_step_whatever_the_batch_spans(arch):
    from repro_torch.serve.fleet import FleetDecoder

    _, cfg = _cfgs(arch, "bfloat16")
    trees, lanes, prompts = _setup(arch)
    fleet = _fleet(trees)
    decoder = FleetDecoder(cfg)
    _, stats = _gen(cfg, fleet, lanes, prompts, decoder=decoder)
    assert stats["distinct_models"] > 1
    assert stats["prefill_dispatches"] == 1
    assert stats["decode_dispatches_per_step"] == 1.0
    assert decoder.dispatches == 1 + N
    _, one = _gen(cfg, fleet, np.zeros(B, np.int64), prompts, decoder=decoder)
    assert one["distinct_models"] == 1
    assert one["prefill_dispatches"] == 1
    assert one["decode_dispatches_per_step"] == 1.0


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-2.7b"])
def test_host_residency_is_bit_equal_to_device(arch, prefetch):
    _, cfg = _cfgs(arch, "bfloat16")
    trees, lanes, prompts = _setup(arch)
    toks_d, _ = _gen(cfg, _fleet(trees), lanes, prompts)
    host = _fleet(trees, resident=False)
    try:
        toks_h, _ = _gen(cfg, host, lanes, prompts)
        assert torch.equal(toks_d, toks_h)
        assert host.stage_seconds > 0          # the cohort was staged
        assert host.overlapped_stage_seconds == 0
        # the next batch: staged ahead by a prefetch, or on demand
        nxt = lanes[:3]
        if prefetch:
            host.prefetch(nxt)
        toks_p, _ = _gen(cfg, host, nxt, prompts[:3])
        assert torch.equal(toks_d[:3], toks_p)
        assert (host.overlapped_stage_seconds > 0) == prefetch
    finally:
        host.close()


def test_temperature_sampling_is_seeded_and_echoes_the_prompts():
    _, cfg = _cfgs("yi-9b", "bfloat16")
    trees, lanes, prompts = _setup("yi-9b")
    fleet = _fleet(trees)
    runs = [_gen(cfg, fleet, lanes, prompts, temperature=0.8, seed=s)[0]
            for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert torch.equal(runs[0][:, :S0], torch.from_numpy(prompts))
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab_size


# ---------------------------------------------------------------------------
# FleetParams with LM trees, and the lane-stacked decode step


def test_fleet_params_carry_the_reference_stacked_tree():
    from repro_torch.serve.fleet import FleetParams

    trees, _, _ = _setup("yi-9b")
    fleet = _fleet(trees)
    assert fleet.nested and fleet.num_clients == K
    names = [name for name, _ in fleet.layout]
    assert names == sorted(names) and "blocks/pos0/attn/wq" in names
    for lane in (0, 3):
        model = fleet.model(lane)
        want = PT.lm_params_from_numpy(trees[lane], CPU)
        assert set(model) == {"embed", "blocks"}
        for (path, got), (_, ref) in zip(
                sorted(jax.tree_util.tree_flatten_with_path(model)[0],
                       key=lambda kv: str(kv[0])),
                sorted(jax.tree_util.tree_flatten_with_path(want)[0],
                       key=lambda kv: str(kv[0]))):
            assert torch.equal(got, ref), path
    # from_trees stacks nested trees the same way
    again = FleetParams.from_trees(trees, device=CPU)
    assert again.layout == fleet.layout
    assert torch.equal(again.rows([0, 1])[0], fleet.rows([0, 1])[0])
    # from_arena keeps a tensor arena where it is, without a copy
    arena = fleet.rows([0])[0]
    view = FleetParams.from_arena(arena, fleet.layout, device=CPU)
    assert view.rows([0])[0].data_ptr() == arena.data_ptr()
    assert view.nested


_LANE_VARIANTS = {
    "plain": {}, "window": {"sliding_window": 4},
    "rolling": {"sliding_window": 4, "rolling_cache": True},
    "tied": {"tie_embeddings": True}}


# a window is an attention option: mamba2 runs the other two
@pytest.mark.parametrize("arch,variant", [
    ("yi-9b", v) for v in _LANE_VARIANTS] + [
    ("mamba2-2.7b", "plain"), ("mamba2-2.7b", "tied")])
def test_lane_stacked_decode_step_equals_decode_step_per_request(arch,
                                                                  variant):
    from repro_torch.nn.module import init_params
    from repro_torch.serve.fleet import FleetParams

    _, cfg = _cfgs(arch, "float32")
    cfg = dataclasses.replace(cfg, **_LANE_VARIANTS[variant])
    models = [init_params(torch.Generator().manual_seed(i),
                          PT.model_specs(cfg), CPU) for i in range(3)]
    fleet = FleetParams.from_trees(models, device=CPU)
    lanes = torch.tensor([2, 0, 2, 1])
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 10)).astype(np.int32))
    cache = PT.init_cache(cfg, 4, 6, dtype=torch.float32, device=CPU)
    solo = [PT.init_cache(cfg, 1, 6, dtype=torch.float32, device=CPU)
            for _ in range(4)]
    tree = fleet.tree(fleet.rows(lanes.numpy())[0])
    for i in range(toks.shape[1] if cfg.rolling_cache else 6):
        meter = [0]
        got, cache = PT.decode_step_lanes(tree, lanes, toks[:, i:i + 1],
                                          cache, i, cfg, meter)
        assert got.shape == (4, 1, cfg.vocab_size) and meter[0] > 0
        for b in range(4):
            want, solo[b] = PT.decode_step(models[int(lanes[b])],
                                           toks[b:b + 1, i:i + 1], solo[b],
                                           i, cfg)
            assert _rel_err(want.numpy(), got[b:b + 1]).max() <= LANES_TOL
    assert decode_attention.launches == 0


def test_lane_rows_gather_one_leaf_when_it_is_read():
    trees, _, _ = _setup("yi-9b")
    fleet = _fleet(trees)
    tree = fleet.tree(fleet.rows(np.arange(K))[0])
    lanes = torch.tensor([4, 1, 1])
    meter = [0]
    rows = PT.LaneRows(tree["blocks"]["pos0"], lanes, 1, meter)
    assert "attn" in rows and "ssm" not in rows and meter == [0]
    wq = rows["attn"]["wq"]
    want = tree["blocks"]["pos0"]["attn"]["wq"][:, 1][lanes]
    assert torch.equal(wq, want) and wq.is_contiguous()
    assert meter == [wq.numel() * 4]


# ---------------------------------------------------------------------------
# the CLI, the families not ported, the fit check, imports


@pytest.mark.parametrize("host", [False, True])
@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-2.7b"])
def test_serve_cli_serves_a_fleet_on_the_cpu(arch, host):
    from repro_torch.launch.serve import main

    buf = io.StringIO()
    with redirect_stdout(buf):
        main(["--fleet", "3", "--smoke", "--device", "cpu", "--arch", arch,
              "--batch", "4", "--prompt-len", "4", "--new-tokens", "3"]
             + (["--fleet-host"] if host else []))
    out = buf.getvalue()
    assert "fleet=3 generated shape: (4, 7) on cpu" in out
    assert "'prefill_dispatches': 1" in out
    assert "'decode_dispatches_per_step': 1.0" in out


def test_the_cli_draws_each_client_from_its_own_seed():
    from repro_torch.launch.serve import draw_fleet, fleet_layout

    cfg = get_smoke_config("yi-9b")
    arena, layout = draw_fleet(cfg, 3, CPU)
    host, _ = draw_fleet(cfg, 3, CPU, host=True)
    assert layout == fleet_layout(cfg) and isinstance(host, np.ndarray)
    np.testing.assert_array_equal(arena.numpy(), host)
    base = PT.init_model(torch.Generator().manual_seed(0), cfg, CPU)
    from repro_torch.utils.tree import flatten_tree
    flat = torch.cat([flatten_tree(base)[name].reshape(-1)
                      for name, _ in layout])
    for k in range(3):
        noise = torch.randn(flat.numel(),
                            generator=torch.Generator().manual_seed(k + 1))
        torch.testing.assert_close(arena[k], flat + 0.01 * noise, rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("family", ["moe", "hybrid"])
def test_unported_families_raise_naming_a10(family):
    """A fleet of a model with MoE layers (the moe family, and the hybrid
    one's jamba) raises naming A10.4b-fleet, in the decoder and the step."""
    from repro_torch.serve.fleet import FleetDecoder

    cfg = (get_smoke_config("jamba-v0.1-52b") if family == "hybrid"
           else dataclasses.replace(get_smoke_config("yi-9b"), family=family))
    with pytest.raises(NotImplementedError, match="ROADMAP A10.4b-fleet"):
        FleetDecoder(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP A10.4b-fleet"):
        PT.decode_step_lanes({}, torch.zeros(1, dtype=torch.long),
                             torch.zeros(1, 1, dtype=torch.int32), {}, 0, cfg)


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_the_vlm_and_audio_families_build_a_fleet_decoder(family):
    from repro_torch.serve.fleet import FleetDecoder

    cfg = dataclasses.replace(get_smoke_config("yi-9b"), family=family)
    assert FleetDecoder(cfg).cfg is cfg


def test_a_fleet_that_cannot_fit_raises_naming_the_bytes():
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import check_fleet_fits

    full = get_config("yi-9b")
    # K = 8 full-width yi-9b models: 8 + 1 of 35.3 GB against an 80 GB card
    with pytest.raises(RuntimeError, match=r"needs 3\d\d\.\d\d GB") as err:
        check_fleet_fits(full, 8, 4, 80 * 10 ** 9)
    assert re.search(r"35\.\d\d GB float32", str(err.value))
    two = dataclasses.replace(full, num_layers=2)
    check_fleet_fits(two, 8, 8, 80 * 10 ** 9)      # chip_smoke's fleet fits
    with pytest.raises(RuntimeError, match="does not fit"):
        check_fleet_fits(two, 8, 8, 30 * 10 ** 9)


def test_importing_the_fleet_path_leaves_jax_unloaded():
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    mods = ["repro_torch.serve", "repro_torch.serve.fleet",
            "repro_torch.launch.serve", "repro_torch.models.transformer"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
