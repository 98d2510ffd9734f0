"""Batched serving driver of the port: prefill a prompt batch, then decode
with cache (the twin of the JAX package's ``launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b

serves the full-width model on the GPU from random weights drawn from a
seed on the card. The dense archs are yi-9b, stablelm-12b (head dim 160),
granite-8b and deepseek-7b (MHA); mamba2-2.7b is the ssm one. Each fits
one 80 GB card in float32 (stablelm-12b's 48.6 GB the largest).
``--smoke`` serves the reduced config the reference's CLI serves, and
``--device cpu`` runs on the CPU. As in the reference, the
prompt is fed through ``decode_step`` one position at a time, so a Mamba2
model serves through its O(1) recurrence and never runs the chunked SSD
scan; that scan is ``launch/steps.py::make_prefill_step``'s. The reference's
``--fleet`` mode (``FleetDecoder``) is not ported yet (ROADMAP A10.2);
classifier fleets serve through ``serve.fleet.FleetClassifier``.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models.transformer import decode_step, init_cache, init_model
from repro_torch.utils.device import resolve_device


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    once at the end."""
    b, s0 = prompts.shape
    device = prompts.device
    cache = init_cache(cfg, b, max_len, dtype=torch.float32, device=device)
    gen = (torch.Generator(device=device).manual_seed(seed)
           if temperature > 0 else None)

    _fence(device)
    t0 = time.perf_counter()
    last_logits, cache = _prefill(params, prompts, cache, cfg)
    _fence(device)
    t1 = time.perf_counter()

    new: List[torch.Tensor] = []
    for i in range(new_tokens):
        if temperature > 0:
            probs = torch.softmax(last_logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            nxt = torch.argmax(last_logits, dim=-1)
        nxt = nxt.to(torch.int32)
        new.append(nxt)
        logits, cache = decode_step(params, nxt[:, None], cache, s0 + i, cfg)
        last_logits = logits[:, -1]
    toks = torch.cat([prompts] + [n[:, None] for n in new], dim=1)
    _fence(device)
    t2 = time.perf_counter()
    decode_s = t2 - t1
    return toks, {
        "prefill_s": t1 - t0,
        "decode_s": decode_s,
        "decode_tok_s": b * new_tokens / max(decode_s, 1e-9),
    }


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="batched LM serving (PyTorch)")
    ap.add_argument("--arch", default="yi-9b",
                    help="yi-9b, stablelm-12b, granite-8b, deepseek-7b or "
                         "mamba2-2.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced config (get_smoke_config)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
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
