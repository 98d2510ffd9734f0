"""Large-architecture FedSR training driver of the port (the twin of the
JAX package's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch fedsr-lm-100m --fused-sgd

trains the ~120M-parameter dense decoder at full width on the GPU from
random weights drawn from a seed on the card; ``--smoke`` trains the
reduced config of ``--arch`` and ``--device cpu`` runs on the CPU.

FedSR maps onto the runtime as in the reference: a stacked client
dimension (the host mesh's "data" size, ``launch/mesh.py::make_host_mesh``;
one device gives one client, a sim host mesh of 8 entries four), a ring
hop each step (a roll of the client stack), cloud aggregation every R
steps (the lanes' mean). Clients see non-IID token streams (different
Markov generators), so the paper's setting — heterogeneous private shards
— is preserved. Attention trains through the flash kernels' forward and
backward on the card; ``--fused-sgd`` updates the whole (C, P) state with
one ``fused_sgd`` launch a step.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.synthetic import make_token_stream
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step, train_layout
from repro_torch.models.transformer import init_model, lm_params_from_numpy
from repro_torch.utils.device import resolve_device
from repro_torch.utils.logging import MetricLogger
from repro_torch.utils.tree import flatten_tree


class ClientTokenStore:
    """Host-resident non-IID client token streams, staged one step at a
    time: the full ``(steps, n_clients, batch, seq+1)`` tensor is never
    materialized; only the current step's ``(n_clients, ...)`` slice is
    assembled and shipped to the device. One Markov generator per client,
    seeded ``seed * 1000 + c``, as in the reference, so the streams are
    the reference's token for token."""

    def __init__(self, cfg: ModelConfig, n_clients: int, batch: int,
                 seq: int, steps: int, seed: int = 0):
        self.streams = [
            make_token_stream(
                vocab_size=cfg.vocab_size,
                num_tokens=steps * batch * (seq + 1),
                seed=seed * 1000 + c,
            ).reshape(steps, batch, seq + 1)
            for c in range(n_clients)
        ]

    def step_batch(self, t: int) -> np.ndarray:
        """The ``(n_clients, batch, seq+1)`` token slice of step ``t``."""
        return np.stack([s[t] for s in self.streams])


def train_loop(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    *,
    steps: int,
    batch_per_client: int,
    seq_len: int,
    log: MetricLogger,
    seed: int = 0,
    init_params: Optional[Mapping[str, Any]] = None,
    device=None,
) -> Dict[str, float]:
    """Train ``steps`` steps on the host mesh's clients; returns the
    reference's four keys (``final_loss``, ``first_loss``, ``params_m``,
    ``seconds``). ``init_params`` is the reference's nested parameter
    tree as numpy arrays (torch cannot replay ``jax.random``); without it
    the weights are drawn from a torch generator seeded ``seed`` on the
    device."""
    device = resolve_device(device)
    n_clients = make_host_mesh(device).shape["data"]
    train_step, cloud_sync = make_train_step(cfg, tcfg)
    layout = train_layout(cfg)
    if init_params is None:
        base = init_model(torch.Generator(device=device).manual_seed(seed),
                          cfg, device)
    else:
        base = lm_params_from_numpy(init_params, device)
    leaves = flatten_tree(base)
    flat = torch.cat([leaves.pop(k).reshape(-1) for k, _ in layout]).to(
        getattr(torch, tcfg.param_dtype))
    del base, leaves
    stack = () if tcfg.ring_mode == "serial" else (n_clients,)
    params = flat.expand(*stack, -1).contiguous()
    state = {"params": params, "mom": torch.zeros_like(params), "step": 0}
    data = ClientTokenStore(cfg, n_clients, batch_per_client, seq_len,
                            steps, seed)
    n_params = flat.numel()
    del flat
    print(f"model: {cfg.name}  params={n_params/1e6:.1f}M  "
          f"clients={n_clients}  ring_mode={tcfg.ring_mode}")

    losses = []
    t0 = time.perf_counter()
    for t in range(steps):
        toks = torch.from_numpy(data.step_batch(t)).to(device)
        batch = {"inputs": toks[..., :-1], "labels": toks[..., 1:]}
        state, loss = train_step(state, batch)
        if (t + 1) % tcfg.cloud_sync_every == 0:
            state = cloud_sync(state)          # eq. 11 cloud aggregation
        losses.append(float(loss))
        if (t + 1) % 10 == 0 or t == 0:
            log.log(t + 1, loss=float(loss),
                    tok_s=batch_per_client * n_clients * seq_len
                    * (t + 1) / (time.perf_counter() - t0))
    return {"final_loss": losses[-1], "first_loss": losses[0],
            "params_m": n_params / 1e6,
            "seconds": time.perf_counter() - t0}


def lm_100m_config() -> ModelConfig:
    """~100M-param dense decoder for the end-to-end driver
    (12 x [4*640^2 + 3*640*2560] + 2*32768*640 = 120M params)."""
    return ModelConfig(
        name="fedsr-lm-100m", family="dense", num_layers=12, d_model=640,
        num_heads=10, num_kv_heads=10, d_ff=2560, vocab_size=32768,
        rope_theta=10_000.0, dtype="float32",
        source="end-to-end driver (deliverable b)",
    )


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="FedSR large-arch training "
                                 "(PyTorch)")
    ap.add_argument("--arch", default="fedsr-lm-100m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config of --arch")
    ap.add_argument("--sync-every", type=int, default=5)
    ap.add_argument("--fused-sgd", action="store_true",
                    help="one fused_sgd kernel launch a step for the update")
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.arch == "fedsr-lm-100m":
        cfg = lm_100m_config()
    elif args.smoke:
        cfg = get_smoke_config(args.arch)
    else:
        cfg = get_config(args.arch)
    tcfg = TrainConfig(param_dtype="float32", learning_rate=0.3,
                       momentum=0.5, cloud_sync_every=args.sync_every,
                       fused_sgd=args.fused_sgd)
    log = MetricLogger(args.log)
    out = train_loop(cfg, tcfg, steps=args.steps,
                     batch_per_client=args.batch, seq_len=args.seq, log=log,
                     device=args.device)
    print({k: round(v, 4) for k, v in out.items()})
    assert out["final_loss"] < out["first_loss"], "training must reduce loss"


if __name__ == "__main__":
    main()
