"""Batched serving driver of the port: prefill a prompt batch, then decode
with cache (the twin of the JAX package's ``launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b

serves the full-width model on the GPU from random weights drawn from a
seed on the card. The dense archs are yi-9b, stablelm-12b (head dim 160),
granite-8b and deepseek-7b (MHA); musicgen-large is the audio one (MHA at
head dim 64 over a 2,048-token codebook), mamba2-2.7b the ssm one and
jamba-v0.1-52b the hybrid one (Mamba2 and attention layers, MoE FFNs on the
odd ones). Each dense, audio and ssm arch fits one 80 GB card in float32
(stablelm-12b's 48.6 GB the largest); the moe archs and jamba do not (jamba
is 205.8 GB in float32, one period of its 8-layer pattern 53.07 GB) and
serve here with ``--smoke``.
The generation loops feed each argmax token back into the model, so a
model fed embeds (``input_mode="embeds"``: llava-next-mistral-7b) cannot
run through them and they raise ``ValueError``; such a model serves through
``launch/steps.py``'s ``make_prefill_step`` and ``make_serve_step``.
``--smoke`` serves the reduced config the reference's CLI serves, and
``--device cpu`` runs on the CPU. As in the reference, the
prompt is fed through ``decode_step`` one position at a time, so a Mamba2
model serves through its O(1) recurrence and never runs the chunked SSD
scan; that scan is ``launch/steps.py::make_prefill_step``'s.

``--fleet K`` serves a personalized fleet instead of one model: client
k's model is the base model plus ``0.01 * N(0, 1)`` drawn from a
generator seeded k + 1 on the device, the K models are one ``(K, P)``
arena, and each request routes to its client's row, so prefill and every
decoded token are one call whatever the batch spans
(``serve.fleet.fleet_prefill_and_decode``). ``--fleet-host`` keeps the
arena in host memory and stages each batch's distinct clients. A fleet
that cannot fit the card raises before drawing, naming the bytes.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models.transformer import (
    decode_step, init_cache, init_model, model_specs, num_repeats,
)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import Layout, flatten_tree, unravel


def fence(device: torch.device) -> float:
    """Wait for the device's queued work, then read the clock."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def next_tokens(logits: torch.Tensor, temperature: float,
                gen: Optional[torch.Generator]) -> torch.Tensor:
    """The next tokens (B,) int32 of last logits (B, V): the argmax, or a
    draw from ``gen`` at ``temperature`` > 0."""
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
    else:
        nxt = torch.argmax(logits, dim=-1)
    return nxt.to(torch.int32)


def check_token_inputs(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless ``cfg``'s model reads token ids, which a
    generation loop feeds back."""
    if cfg.input_mode != "tokens":
        raise ValueError(
            f"{cfg.name} reads input_mode={cfg.input_mode!r}: a generation "
            "loop feeds argmax tokens back into the model, which an embeds "
            "model cannot take; serve it with launch/steps.py's "
            "make_prefill_step and make_serve_step, fed (B, S, d) and "
            "(B, 1, d) embeds")


def _prefill(params, prompts: torch.Tensor, cache, cfg: ModelConfig):
    """Fill the cache one prompt position at a time, as the reference's
    ``lax.scan`` of ``decode_step`` does. Returns (last logits (B, V),
    cache)."""
    logits = None
    for i in range(prompts.shape[1]):
        logits, cache = decode_step(params, prompts[:, i:i + 1], cache, i, cfg)
    return logits[:, 0], cache


def prefill_and_decode(
    cfg: ModelConfig,
    params,
    prompts: torch.Tensor,        # (B, S0) int32
    *,
    max_len: int,
    new_tokens: int,
    temperature: float = 0.0,
    seed: int = 0,
) -> Tuple[torch.Tensor, dict]:
    """Greedy or temperature batched generation on ``prompts``' device.
    Returns (tokens (B, S0 + N), stats). Temperature sampling draws from a
    ``torch.Generator`` seeded with ``seed`` on that device. Every clock
    read is fenced by a device synchronize, and decoded tokens are joined
    once at the end. Raises ``ValueError`` for an embeds model
    (``check_token_inputs``)."""
    check_token_inputs(cfg)
    b, s0 = prompts.shape
    device = prompts.device
    cache = init_cache(cfg, b, max_len, dtype=torch.float32, device=device)
    gen = (torch.Generator(device=device).manual_seed(seed)
           if temperature > 0 else None)

    t0 = fence(device)
    last_logits, cache = _prefill(params, prompts, cache, cfg)
    t1 = fence(device)

    new: List[torch.Tensor] = []
    for i in range(new_tokens):
        nxt = next_tokens(last_logits, temperature, gen)
        new.append(nxt)
        logits, cache = decode_step(params, nxt[:, None], cache, s0 + i, cfg)
        last_logits = logits[:, -1]
    toks = torch.cat([prompts] + [n[:, None] for n in new], dim=1)
    t2 = fence(device)
    decode_s = t2 - t1
    return toks, {
        "prefill_s": t1 - t0,
        "decode_s": decode_s,
        "decode_tok_s": b * new_tokens / max(decode_s, 1e-9),
    }


def fleet_layout(cfg: ModelConfig) -> Layout:
    """One model of ``cfg`` as a fleet row: its leaves under ``/``-joined
    names, sorted (``FleetParams``' layout of a nested tree)."""
    flat = flatten_tree(model_specs(cfg))
    return tuple((k, tuple(flat[k].shape)) for k in sorted(flat))


def check_fleet_fits(cfg: ModelConfig, rows: int, batch: int,
                     free_bytes: int) -> None:
    """Raise, naming the bytes, unless ``rows`` float32 models of ``cfg``,
    the base model they are drawn from and the largest leaf's rows for
    ``batch`` requests (what a fleet decode step gathers at once) fit in
    ``free_bytes``."""
    layout, reps = fleet_layout(cfg), num_repeats(cfg)
    model = 4 * sum(math.prod(shape) for _, shape in layout)
    gathered = 4 * batch * max(
        math.prod(shape) // (reps if name.startswith("blocks/") else 1)
        for name, shape in layout)
    need = (rows + 1) * model + gathered
    if need > free_bytes:
        raise RuntimeError(
            f"a fleet of {rows} resident {cfg.name} models does not fit: it "
            f"needs {need / 1e9:.2f} GB ({rows} + 1 models of "
            f"{model / 1e9:.2f} GB float32 and {gathered / 1e9:.2f} GB of "
            f"rows gathered for {batch} requests), {free_bytes / 1e9:.2f} GB "
            "are free; serve fewer clients, --fleet-host or --smoke")


# each client's model: the base model plus FLEET_NOISE * N(0, 1), a
# stand-in for a personalized fine-tune, as the reference's CLI draws it
FLEET_NOISE = 0.01


def draw_fleet(cfg: ModelConfig, clients: int, device: torch.device,
               host: bool = False):
    """The CLI's fleet as one ``(K, P)`` float32 arena in
    ``fleet_layout(cfg)``: client k is the base model (``init_model`` from a
    generator seeded 0 on ``device``) plus ``FLEET_NOISE * N(0, 1)`` from a
    generator seeded k + 1 on ``device``, each row drawn on the device.
    The arena stays there, or with ``host`` is a host numpy array. Returns
    (arena, layout)."""
    layout = fleet_layout(cfg)
    width = sum(math.prod(shape) for _, shape in layout)
    base = flatten_tree(init_model(
        torch.Generator(device=device).manual_seed(0), cfg, device))
    arena = (np.empty((clients, width), np.float32) if host else
             torch.empty((clients, width), dtype=torch.float32,
                         device=device))
    row = (torch.empty(width, dtype=torch.float32, device=device) if host
           else None)
    for k in range(clients):
        r = row if host else arena[k]
        for name, view in unravel(r, layout).items():
            view.copy_(base[name])
        gen = torch.Generator(device=device).manual_seed(k + 1)
        r.add_(torch.randn(width, generator=gen, device=device),
               alpha=FLEET_NOISE)
        if host:
            arena[k] = r.cpu().numpy()
    return arena, layout


def _serve_fleet(args, cfg: ModelConfig, device: torch.device) -> None:
    """``--fleet``: K client variants in one arena, the batch's requests
    routed by lane, one call a step across all of them."""
    from repro_torch.serve.fleet import FleetParams, fleet_prefill_and_decode

    rng = np.random.default_rng(0)
    lanes = rng.integers(0, args.fleet, size=args.batch)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(args.batch, args.prompt_len)).astype(np.int32)
    if device.type == "cuda":
        rows = len(np.unique(lanes)) if args.fleet_host else args.fleet
        check_fleet_fits(cfg, rows, args.batch,
                         torch.cuda.mem_get_info(device)[0])
    arena, layout = draw_fleet(cfg, args.fleet, device, host=args.fleet_host)
    fleet = FleetParams.from_arena(arena, layout, resident=not args.fleet_host,
                                   device=device)
    try:
        toks, stats = fleet_prefill_and_decode(
            cfg, fleet, lanes, prompts,
            max_len=args.prompt_len + args.new_tokens,
            new_tokens=args.new_tokens)
    finally:
        fleet.close()
    print(f"fleet={args.fleet} generated shape: {tuple(toks.shape)} on "
          f"{device}")
    print({k: round(v, 3) if isinstance(v, float) else v
           for k, v in stats.items()})


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="batched LM serving (PyTorch)")
    ap.add_argument("--arch", default="yi-9b",
                    help="yi-9b, stablelm-12b, granite-8b, deepseek-7b, "
                         "musicgen-large, mamba2-2.7b, the moe archs or "
                         "jamba-v0.1-52b (llava-next-mistral-7b reads "
                         "embeds and raises)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced config (get_smoke_config)")
    ap.add_argument("--fleet", type=int, default=0,
                    help=">0: serve a K-model personalized fleet, requests "
                         "routed by lane id (serve.fleet)")
    ap.add_argument("--fleet-host", action="store_true",
                    help="keep the fleet arena in host memory and stage "
                         "only each batch's clients")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    check_token_inputs(cfg)        # before any weights are drawn
    if args.fleet > 0:
        _serve_fleet(args, cfg, device)
        return
    params = init_model(torch.Generator(device=device).manual_seed(0), cfg,
                        device)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len)).astype(
            np.int32)).to(device)
    toks, stats = prefill_and_decode(
        cfg, params, prompts,
        max_len=args.prompt_len + args.new_tokens,
        new_tokens=args.new_tokens,
    )
    print(f"generated shape: {tuple(toks.shape)} on {device}")
    print({k: round(v, 3) for k, v in stats.items()})


if __name__ == "__main__":
    main()
