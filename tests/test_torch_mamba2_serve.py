"""The port's Mamba2 serving path (mamba2-2.7b's reduced config) against
the JAX package's, with the reference's weights carried across.

* Configs: ``configs/mamba2_2_7b.py`` and its smoke reduction equal the
  reference's field by field; jamba (hybrid, ported since) resolves to
  the reference's configs and pattern.
* Specs: ``models/mamba2.py``'s names, shapes and init kinds equal the
  reference's; the SSM cache is float32 whatever dtype is asked for.
* ``forward`` (the chunked scan), ``decode_step`` with its conv and SSM
  caches, and greedy ``prefill_and_decode`` against
  ``repro.models.transformer`` / ``repro.launch.serve``.

Tolerances and their reasons. Mamba2 has no attention, so nothing near
one-hot passes a rounding difference on whole.
* float32: every position's logits within 1e-4 * max(1, max|logit|) of
  the reference's (measured about 3e-6: the projections and the chunked
  sums run in another order); the caches within 1e-5 of their scale.
* bfloat16: both packages round the projections' and the conv's outputs to
  bfloat16, at places where their float32 sums differ by an ulp now and
  then: 95% of positions within 3e-2 * max|logit|, every position within
  1e-1, top-1 equal at >= 95% of positions.
"""
import dataclasses
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.mamba2_2_7b import CONFIG as REF_CONFIG
from repro.configs.mamba2_2_7b import SMOKE as REF_SMOKE
from repro.models import transformer as RT
from repro_torch.configs.mamba2_2_7b import CONFIG, SMOKE
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models import transformer as PT

CPU = torch.device("cpu")
F32_MAX, CACHE_TOL = 1e-4, 1e-5
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
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


def _rel_err(ref, port):
    ref = np.asarray(ref, np.float32)
    port = port.float().numpy() if hasattr(port, "numpy") else port
    scale = max(1.0, float(np.abs(ref).max()))
    return np.abs(ref - port).max(-1).ravel() / scale


def _assert_close(ref, port, dtype):
    e = _rel_err(ref, port)
    if dtype == "float32":
        assert e.max() <= F32_MAX, e.max()
        return
    assert np.mean(e <= BF16_BULK) >= 0.95, np.sort(e)[-10:]
    assert e.max() <= BF16_MAX, e.max()
    top1 = np.mean(np.asarray(ref, np.float32).argmax(-1)
                   == port.float().numpy().argmax(-1))
    assert top1 >= BF16_TOP1, top1


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------------------
# configs, specs, caches


def test_mamba2_configs_equal_the_reference():
    from repro.configs import registry as ref_reg
    from repro_torch.configs import registry as reg

    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(REF_CONFIG)
    assert dataclasses.asdict(SMOKE) == dataclasses.asdict(REF_SMOKE)
    assert (dataclasses.asdict(reg.get_config("mamba2-2.7b"))
            == dataclasses.asdict(ref_reg.get_config("mamba2-2.7b")))
    assert (dataclasses.asdict(reg.get_smoke_config("mamba2-2.7b"))
            == dataclasses.asdict(ref_reg.get_smoke_config("mamba2-2.7b")))
    assert (SMOKE.ssm_state, SMOKE.ssm_chunk, SMOKE.num_layers) == (16, 32, 2)


def test_jamba_still_raises_naming_a10():
    """Ported since (ROADMAP A10.4c): jamba resolves to the reference's
    configs, and its Mamba2 layers sit where the reference's do."""
    from repro.configs import registry as ref_reg
    from repro_torch.configs.registry import get_config, get_smoke_config
    for fn, ref_fn in ((get_config, ref_reg.get_config),
                       (get_smoke_config, ref_reg.get_smoke_config)):
        cfg, ref_cfg = fn("jamba-v0.1-52b"), ref_fn("jamba-v0.1-52b")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
        assert PT.block_pattern(cfg) == RT.block_pattern(ref_cfg)
    assert PT.block_pattern(get_smoke_config("jamba-v0.1-52b")) == [
        ("ssm", "dense"), ("attn", "moe")]
    assert PT.block_pattern(SMOKE) == RT.block_pattern(REF_SMOKE) == [
        ("ssm", "none")]


@pytest.mark.parametrize("arch_cfg", ["smoke", "full"])
def test_model_specs_have_the_reference_shapes_and_init_kinds(arch_cfg):
    from repro.nn.module import param_count as ref_param_count
    from repro_torch.models.registry import specs_for
    from repro_torch.nn.module import param_count

    ref_cfg, cfg = ((REF_SMOKE, SMOKE) if arch_cfg == "smoke"
                    else (REF_CONFIG, CONFIG))
    ref, port = _flat(RT.model_specs(ref_cfg)), _flat(PT.model_specs(cfg))
    assert list(ref) == list(port)
    assert "blocks/pos0/ssm/in_proj" in port
    for k in ref:
        assert tuple(port[k].shape) == tuple(ref[k].shape), k
        assert (port[k].init, port[k].scale) == (ref[k].init, ref[k].scale), k
    assert param_count(specs_for(cfg)) == ref_param_count(
        RT.model_specs(ref_cfg))


def test_registry_init_draws_the_ssm_tree():
    from repro_torch.models.registry import init_for

    p = init_for(torch.Generator().manual_seed(0), SMOKE, CPU)
    q = PT.init_model(torch.Generator().manual_seed(0), SMOKE, CPU)
    assert list(_flat(p)) == list(_flat(PT.model_specs(SMOKE)))
    assert all(torch.equal(a, b) for a, b in
               zip(_flat(p).values(), _flat(q).values()))
    ssm = p["blocks"]["pos0"]["ssm"]
    assert torch.equal(ssm["d_skip"], torch.ones_like(ssm["d_skip"]))
    assert torch.equal(ssm["a_log"], torch.zeros_like(ssm["a_log"]))
    # conv_w is (layers, W, C): fan_in reads shape[-2], the conv width
    assert abs(ssm["conv_w"].std().item() / 0.5 - 1) < 0.05


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_cache_is_float32_with_the_reference_shapes(dtype):
    ref = RT.cache_specs(REF_SMOKE, 3, 20, dtype=jnp.bfloat16)
    port = PT.cache_specs(SMOKE, 3, 20, dtype=dtype)
    for k in ("conv", "ssm"):
        r, p = ref["pos0"]["ssm"][k], port["pos0"]["ssm"][k]
        assert tuple(p.shape) == tuple(r.shape) and p.dtype == torch.float32
    cache = PT.init_cache(SMOKE, 3, 20, dtype=dtype, device=CPU)
    assert cache["pos0"]["ssm"]["ssm"].shape == (2, 3, 8, 16, 64)
    assert not cache["pos0"]["ssm"]["conv"].any()


def test_lm_params_from_numpy_keeps_the_mamba_tree():
    params, port = _weights(REF_SMOKE)
    ref = _flat(jax.tree.map(np.asarray, params))
    got = _flat(port)
    assert list(ref) == list(got)
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k].numpy())


# ---------------------------------------------------------------------------
# forward (prefill) and decode


@pytest.mark.parametrize("dtype,variant", [
    ("float32", {}), ("float32", {"ssm_chunk": 16}), ("bfloat16", {})])
def test_forward_matches_reference(dtype, variant):
    """40 positions: a ragged last chunk at chunk 32, two and a half chunks
    at 16."""
    ref_cfg, cfg = _cfgs(dtype=dtype, **variant)
    params, port = _weights(ref_cfg)
    toks = _tokens(cfg, (2, 40))
    ref, _ = RT.forward(params, jnp.asarray(toks), ref_cfg)
    got, aux = PT.forward(port, torch.from_numpy(toks), cfg)
    assert got.shape == (2, 40, cfg.vocab_size)
    assert got.dtype == getattr(torch, dtype) and float(aux) == 0.0
    _assert_close(ref, got, dtype)


def test_ssd_intra_dtype_bfloat16_follows_the_kernel_contract():
    """ROADMAP C4: with ``ssd_intra_dtype="bfloat16"`` the reference model
    rounds inside the chunk; the port, like the Pallas kernel, does not,
    so it equals the reference model run with ``"float32"``."""
    ref_cfg, cfg = _cfgs(dtype="float32", ssd_intra_dtype="bfloat16")
    params, port = _weights(ref_cfg)
    toks = _tokens(cfg, (2, 40))
    rounded, _ = RT.forward(params, jnp.asarray(toks), ref_cfg)
    contract, _ = RT.forward(params, jnp.asarray(toks), dataclasses.replace(
        ref_cfg, ssd_intra_dtype="float32"))
    got, _ = PT.forward(port, torch.from_numpy(toks), cfg)
    _assert_close(contract, got, "float32")
    assert _rel_err(rounded, np.asarray(contract)).max() > 10 * F32_MAX


def test_prefill_step_is_forward_and_never_launches_on_the_cpu():
    from repro_torch.launch.steps import make_prefill_step

    _, cfg = _cfgs(dtype="float32")
    _, port = _weights(REF_SMOKE)
    toks = torch.from_numpy(_tokens(cfg, (1, 16)))
    got = make_prefill_step(cfg)(port, toks)
    assert torch.equal(got, PT.forward(port, toks, cfg)[0])
    assert ssd_scan.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference_with_its_caches(dtype):
    """Teacher-forced decode: logits at every step, and the conv window and
    SSM state the port wrote in place against the reference's new cache."""
    from repro_torch.launch.steps import make_serve_step

    ref_cfg, cfg = _cfgs(dtype=dtype)
    params, port = _weights(ref_cfg)
    batch, steps = 2, 20
    toks = _tokens(cfg, (batch, steps), seed=1)
    rcache = RT.init_cache(ref_cfg, batch, steps, dtype=jnp.float32)
    pcache = PT.init_cache(cfg, batch, steps, dtype=torch.float32, device=CPU)
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
    _assert_close(np.concatenate(refs, 1), torch.cat(ports, 1), dtype)
    # bfloat16 caches hold float32 sums of bfloat16-rounded inputs
    tol = CACHE_TOL if dtype == "float32" else 2e-2
    for k in ("conv", "ssm"):
        r = np.asarray(rcache["pos0"]["ssm"][k])
        p = pcache["pos0"]["ssm"][k].numpy()
        assert p.dtype == np.float32 and p.shape == r.shape
        assert np.abs(p - r).max() <= tol * max(1.0, np.abs(r).max()), k
    assert ssd_scan.launches == 0


def test_chunked_forward_equals_the_recurrence():
    """Inside the port: ``forward`` (the chunked scan) and ``decode_step``
    fed the same tokens (the recurrence) give the same logits."""
    from repro_torch.launch.steps import make_serve_step

    _, cfg = _cfgs(dtype="float32")
    _, port = _weights(REF_SMOKE)
    toks = torch.from_numpy(_tokens(cfg, (2, 40), seed=4))
    full, _ = PT.forward(port, toks, cfg)
    cache = PT.init_cache(cfg, 2, 40, dtype=torch.float32, device=CPU)
    step = make_serve_step(cfg)
    steps = [step(port, cache, toks[:, i:i + 1], i)[0] for i in range(40)]
    assert _rel_err(full.numpy(), torch.cat(steps, 1)).max() <= 1e-5


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
    assert ssd_scan.launches == 0


# ---------------------------------------------------------------------------
# entry point and imports


def test_serve_cli_serves_mamba2_on_the_cpu():
    from repro_torch.launch.serve import main

    buf = io.StringIO()
    with redirect_stdout(buf):
        main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu",
              "--batch", "2", "--prompt-len", "4", "--new-tokens", "3"])
    out = buf.getvalue()
    assert "generated shape: (2, 7) on cpu" in out
    assert "decode_tok_s" in out


def test_serve_cli_defaults_to_the_gpu():
    from repro_torch.launch.serve import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "mamba2-2.7b", "--smoke"])


def test_importing_the_mamba2_path_leaves_jax_unloaded():
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    mods = ["repro_torch.models.mamba2", "repro_torch.configs.mamba2_2_7b",
            "repro_torch.kernels.ssd_scan", "repro_torch.kernels.ssd_scan.kernel"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
