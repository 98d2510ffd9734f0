#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero, before any result line is printed):

1. Device and build: the card's name and power limit, then the CUDA
   kernels built from ``src/repro_torch/csrc`` (nvcc, ``sm_90a``).
2. Every kernel against its plain PyTorch version on the card, over the
   sweep of the JAX package's own kernel tests plus the main path's shape;
   the results must be equal bit for bit.
3. The main path: ``repro_torch`` ``run_experiment`` runs FedSR on the paper
   MLP at full width (199,210 parameters, ``mnist_like`` at its default
   2,000/400 images, K=20, M=5, R=5, E=1, batch 32, ``engine="fused"``,
   ``use_fused_sgd=True``) for 10 rounds with an eval every 5, from seeded
   random weights — on the GPU, then on the CPU from the same weights,
   where the plain versions run. The kernel must have launched once per
   SGD step the plans imply, one dispatch per block; plans, comm meters and
   H2D bytes must be identical between the two runs, every eval's accuracy
   within 0.02 of the CPU run's, and the final accuracy well above chance.
4. Times, every one fenced by a device synchronize: the kernel, its plain
   version and one ``torch._fused_sgd_`` call (the op behind
   ``torch.optim.SGD(fused=True)``, a yardstick the port never calls), each
   with the L2 cache flushed before every launch; and the main path's wall
   time per round.
5. Where a steady-state round's time goes: ``torch.profiler`` over one
   round, device-busy share and kernels by device time.

The last lines of standard output are one JSON line describing every
kernel, the card's ``nvidia-smi`` name and power limit, and the result
line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12     # H100 SXM datasheet memory rate
H100_F32_FLOPS = 67e12         # H100 SXM datasheet float32 (non-tensor) rate
MAIN_SHAPE = (5, 199_210)      # M=5 ring lanes x the paper MLP's parameters
SWEEP_N = (1, 255, 257, 1023, 4097, 199_210)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_sweep(fused_sgd_lanes, sgd_lanes_reference) -> float:
    """Phase 2: the kernel equals its plain version bit for bit. Returns
    the largest absolute difference seen (0.0 when it passes)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for n in SWEEP_N:
        for nesterov in (False, True):
            cases.append(((5, n), 0.9, nesterov))
    cases += [((5, 199_210), 0.0, False), ((1, 64), 0.0, False),
              ((3, 300), 0.5, True), (MAIN_SHAPE, 0.5, False)]
    masks = ([True] * 5, [True, False, True, True, False], [False] * 5)
    worst = 0.0
    for shape, momentum, nesterov in cases:
        C = shape[0]
        p, g, m = (torch.randn(shape, device="cuda", generator=gen)
                   for _ in range(3))
        lr = torch.tensor([0.02], device="cuda")
        for mask in masks:
            ok = torch.tensor(mask[:C], device="cuda")
            for reset in (False, True):
                want_p, want_m = sgd_lanes_reference(
                    p, g, m, ok, lr, reset=reset, momentum=momentum,
                    nesterov=nesterov)
                got_p, got_m = p.clone(), m.clone()
                fused_sgd_lanes(got_p, g, got_m, ok, lr, reset=reset,
                                momentum=momentum, nesterov=nesterov)
                torch.cuda.synchronize()
                err = max((got_p - want_p).abs().max().item(),
                          (got_m - want_m).abs().max().item())
                worst = max(worst, err)
                check(torch.equal(got_p, want_p) and torch.equal(got_m, want_m),
                      f"fused_sgd != plain version at shape={shape} "
                      f"momentum={momentum} nesterov={nesterov} "
                      f"ok={mask[:C]} reset={reset} (max |diff| {err})")
    log(f"[kernel] fused_sgd equals its plain version bit for bit over "
        f"{len(cases) * len(masks) * 2} cases")
    return worst


def main_path(run_experiment, fused_sgd_lanes, cfg, fl, init):
    """Phase 3: the GPU run with launch counting, then the CPU run."""
    runs = {}
    for device in ("cuda", "cpu"):
        blocks = []
        fused_sgd_lanes.launches = 0
        t0 = time.perf_counter()
        res = run_experiment(task="mnist_like", model_cfg=cfg, fl=fl,
                             eval_every=5, init_params=init, device=device,
                             on_block=lambda t, s, b=blocks: b.append((t, s)))
        wall = time.perf_counter() - t0
        runs[device] = (res, blocks, fused_sgd_lanes.launches, wall)
        log(f"[main] {device}: accuracies "
            f"{[round(r.accuracy, 4) for r in res.history]} "
            f"launches={fused_sgd_lanes.launches} "
            f"dispatches={res.dispatches} h2d_bytes={res.h2d_bytes} "
            f"wall={wall:.3f}s")
    return runs


def check_main_path(runs, cfg) -> None:
    gpu, gblocks, glaunch, _ = runs["cuda"]
    cpu, cblocks, claunch, _ = runs["cpu"]
    steps = 0
    for _, sched in gblocks:
        groups = [p.groups[0] for p in sched.plans]
        H = max(len(g.hops) for g in groups)
        S = max(p.shape[0] for g in groups for h in g.hops for p in h.plans
                if p is not None)
        steps += len(sched.plans) * H * S
    log(f"[main] the plans imply {steps} SGD steps over {len(gblocks)} blocks")
    check(glaunch == steps, f"fused_sgd launched {glaunch} times, the plans "
          f"imply {steps} steps")
    check(claunch == 0, "the CPU run launched the CUDA kernel")
    check(gpu.dispatches == len(gblocks) == cpu.dispatches,
          f"dispatches {gpu.dispatches}/{cpu.dispatches} != blocks "
          f"{len(gblocks)}")
    check(len(gblocks) == len(cblocks), "block counts differ")
    for (ta, sa), (tb, sb) in zip(gblocks, cblocks):
        check(ta == tb and sa.comm == sb.comm, "block comm differs")
        for pa, pb in zip(sa.plans, sb.plans):
            check(pa.comm == pb.comm and pa.sim_seconds == pb.sim_seconds,
                  "round comm differs")
            for ga, gb in zip(pa.groups, pb.groups):
                check(ga.agg == gb.agg, "aggregation weights differ")
                for ha, hb in zip(ga.hops, gb.hops):
                    check(ha.ids == hb.ids, "ring orders differ")
                    for a, b in zip(ha.plans, hb.plans):
                        check((a is None) == (b is None) and (
                            a is None or np.array_equal(a, b)),
                            "batch plans differ")
    check(gpu.h2d_bytes == cpu.h2d_bytes, "h2d_bytes differ")
    check([r.round for r in gpu.history] == [r.round for r in cpu.history],
          "eval rounds differ")
    for a, b in zip(gpu.history, cpu.history):
        check(a.comm == b.comm, f"comm meters differ at round {a.round}")
        check(abs(a.accuracy - b.accuracy) <= 0.02,
              f"round {a.round}: GPU accuracy {a.accuracy} vs CPU "
              f"{b.accuracy}")
    check(gpu.final_accuracy > 0.5,
          f"final accuracy {gpu.final_accuracy} is not well above chance")
    for k, v in gpu.final_model.items():
        check(bool(torch.isfinite(v).all()), f"non-finite weights in {k}")
    n_params = sum(v.numel() for v in gpu.final_model.values())
    check(n_params == 199_210, f"{n_params} parameters, expected 199,210")


def time_launch(fn, reps: int = 50) -> float:
    """Median ms of one call of ``fn``, timed alone with CUDA events. Before
    every call a 256 MB write flushes the 50 MB L2 cache, and a spin kernel
    then holds the card while the host enqueues the call, so host launch
    gaps stay out of the measured interval."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    times = []
    for i in range(reps + 5):
        flush.fill_(float(i))
        torch.cuda._sleep(1_000_000)        # ~0.5 ms of device time
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i >= 5:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_kernels(fused_sgd_lanes, sgd_lanes_reference):
    C, P = MAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(1)
    p, g, m = (torch.randn(MAIN_SHAPE, device="cuda", generator=gen)
               for _ in range(3))
    ok = torch.ones(C, dtype=torch.bool, device="cuda")
    lr = torch.tensor([1e-4], device="cuda")
    kw = {"reset": False, "momentum": 0.5}
    before = fused_sgd_lanes.launches
    ms = time_launch(lambda: fused_sgd_lanes(p, g, m, ok, lr, **kw))
    fused_sgd_lanes.launches = before       # timing launches are not the path's
    plain_ms = time_launch(lambda: sgd_lanes_reference(p, g, m, ok, lr, **kw))
    ps, gs, ms_ = [p.view(-1)], [g.view(-1)], [m.view(-1)]
    library_ms = time_launch(lambda: torch._fused_sgd_(
        ps, gs, ms_, weight_decay=0.0, momentum=0.5, lr=1e-4, dampening=0.0,
        nesterov=False, maximize=False, is_first_step=False))
    nbytes = 20 * C * P + C + 4          # read p, g, m, ok, lr; write p, m
    flops = 4 * C * P
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = flops / H100_F32_FLOPS * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def profile_round(cfg, fl, init) -> None:
    """Phase 5: where one steady-state round of the main path spends its
    time — ``torch.profiler`` over one round after a warm-up round; prints
    the wall, the device-busy share and the kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.algorithms import make_algorithm
    from repro_torch.core.local import LocalTrainer
    from repro_torch.data.pipeline import make_clients
    from repro_torch.data.synthetic import make_task
    from repro_torch.models.small import params_from_numpy
    from repro_torch.utils.tree import ravel_params

    rng = np.random.default_rng(fl.seed)
    train, _ = make_task("mnist_like", seed=fl.seed)
    clients = make_clients(train, scheme=fl.partition,
                           num_devices=fl.num_devices, rng=rng)
    algo = make_algorithm("fedsr", LocalTrainer(cfg, fl, "cuda"), clients,
                          fl)
    w = ravel_params(params_from_numpy(init, torch.device("cuda")))
    w, _ = algo.run_schedule(w, 0, np.asarray([0.01]), rng, None, {})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        w, _ = algo.run_schedule(w, 1, np.asarray([0.01]), rng, None, {})
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: an aten op's row repeats the time of the
    # kernels it launched, so summing every row would count it twice
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    log(f"[profile] one round (profiler on): wall {wall_us / 1e3:.3f} ms, "
        f"{launches} device kernels, busy {busy / 1e3:.3f} ms "
        f"({100 * busy / wall_us:.1f}%), idle {100 * (1 - busy / wall_us):.1f}%")
    for dev, count, key in rows[:10]:
        log(f"[profile]   {dev / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.configs.base import FLConfig
    from repro_torch.configs.fedsr_mlp import CONFIG
    from repro_torch.core.executor import run_experiment
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_sgd.ops import fused_sgd_lanes
    from repro_torch.kernels.fused_sgd.ref import sgd_lanes_reference
    from repro_torch.models.small import init_small_model, params_to_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    build.build(["fused_sgd"])
    log(f"[build] fused_sgd in {time.perf_counter() - t0:.1f}s")
    for line in build.BUILD_LOGS.get("fused_sgd", "").splitlines():
        if "ptxas" in line:
            log(f"[build] {line.strip()}")

    max_abs_err = kernel_sweep(fused_sgd_lanes, sgd_lanes_reference)

    fl = FLConfig(algorithm="fedsr", partition="pathological",
                  num_devices=20, num_edges=5, ring_rounds=5,
                  local_epochs=1, batch_size=32, rounds=10,
                  engine="fused", use_fused_sgd=True, seed=0)
    init = params_to_numpy(init_small_model(
        torch.Generator().manual_seed(0), CONFIG, torch.device("cpu")))
    runs = main_path(run_experiment, fused_sgd_lanes, CONFIG, fl, init)
    launches = runs["cuda"][2]
    check_main_path(runs, CONFIG)
    log("[main] checks passed: launches per step, one dispatch per block, "
        "identical plans/meters/h2d, accuracy within 0.02 of the CPU run")
    gpu_hist = runs["cuda"][0].history
    for rec in gpu_hist:
        log(f"[main] cuda block ending round {rec.round}: "
            f"{rec.seconds * 1e3 / rec.rounds:.2f} ms/round "
            f"(acc {rec.accuracy:.4f})")
    cpu_hist = runs["cpu"][0].history
    log(f"[main] cpu: {sum(r.seconds for r in cpu_hist) * 1e3 / fl.rounds:.2f}"
        f" ms/round")

    times = time_kernels(fused_sgd_lanes, sgd_lanes_reference)
    log(f"[time] fused_sgd at {MAIN_SHAPE}: kernel {times['ms']:.5f} ms, "
        f"plain {times['plain_ms']:.5f} ms, torch._fused_sgd_ "
        f"{times['library_ms']:.5f} ms, bound {times['bound_ms']:.5f} ms "
        f"({times['bound_by']})")
    profile_round(CONFIG, fl, init)

    kernels = [{
        "name": "fused_sgd", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_sgd.cu",
        "replaces": "src/repro/kernels/fused_sgd/kernel.py:33",
        "launches": launches, "max_abs_err": max_abs_err, **times,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
