#!/usr/bin/env python3
"""The flash attention backward on the card, alone: build, check, time.

Runs ``chip_smoke.py``'s parts of the backward without the rest: builds
``flash_attention`` and ``flash_attention_bwd`` from
``src/repro_torch/csrc``, logs ptxas's registers and spills of each
forward and backward kernel, the ``HGMMA`` / ``UTMALDG`` counts of the
backward's bfloat16 kernels and the ``LDGSTS`` counts of the float32
kernels (phase 1), holds the backward against the plain backward computed
in float64 over phase 2's sweep (192 cases, ``BWD_TOL``, reruns
bit-equal), and times it at yi-9b's and stablelm-12b's training shapes in
bfloat16 and at a fedsr-lm-100m lane in float32 (phase 9's
``time_flash_bwd``: cold L2, against its bound, the plain backward and
SDPA's backward; the forward with and without lse beside SDPA's forward).
Needs one CUDA card; run from the repository root:

    python3 scripts/flash_bwd_probe.py [--lane-only] [--root DIR]

``--lane-only`` builds and times the float32 lane alone (no sweep, no
bfloat16 shapes). ``--root DIR`` takes ``chip_smoke.py`` and
``src/repro_torch`` from another checkout (e.g. the parent commit unpacked
under ``build/``), which builds its kernels into its own ``build/``, so
two commits' kernels are timed in one call on one card.

Exits non-zero when a check failed.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lane-only", action="store_true")
    ap.add_argument("--root", type=Path, default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    cs = importlib.import_module("chip_smoke")   # puts its src/ on the path
    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd

    cs.log(f"[device] {cs.nvidia_smi()} | torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    names = ["flash_attention", "flash_attention_bwd"]
    t0 = time.perf_counter()
    build.build(names)
    cs.log(f"[build] {', '.join(names)} in {time.perf_counter() - t0:.1f}s")
    cs.log(f"[probe] the kernels of {build.CSRC}")
    for name in names:
        for kernel, report in cs.ptxas_by_kernel(
                build.BUILD_LOGS.get(name) or "").items():
            cs.log(f"[build] {name} {kernel}: {report}")
    if not args.lane_only:
        cs.check_flash_bwd_sass(build)
        cs.check_simt_sass(build)
        cs.flash_bwd_sweep(flash_attention_bwd)
        for shape in (cs.FLASH_PATH, cs.FLASH_PATH_160):
            cs.time_flash_bwd(flash_attention_bwd, shape, torch.bfloat16, 20)
    cs.time_flash_bwd(flash_attention_bwd, cs.BWD_PATH, torch.float32, 20)
    if cs.FAILURES:
        print(f"flash_bwd_probe: FAILED {len(cs.FAILURES)} check(s):",
              file=sys.stderr)
        for what in cs.FAILURES:
            print(f"  {what}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
