"""chip_smoke.py's hybrid-family phases alone, on one card: phase 2's scan
sweep and pass check (jamba's N = 16 among them), the CPU bit check of
the bfloat16 pre-cast, phase 4e (jamba-v0.1-52b at 2 layers, GPU against
CPU, both controls), phase 5e (8 of its 32 layers, timed and profiled)
and phase 8's jamba rows. Run from the repository root:

    python3 scripts/hybrid_probe.py

It builds flash_attention, decode_attention and ssd_scan, and runs the
CPU reference in one worker of 7 threads (chip_smoke.py runs two of 3),
so its worker times are not the whole run's. Exits non-zero if a check
failed."""
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    from repro_torch.configs.jamba_v0_1_52b import CONFIG as JAMBA
    from repro_torch.configs.jamba_v0_1_52b import SMOKE
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain,
    )
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.kernels.ssd_scan.ops import (
        kernel_route, ssd_scan, ssd_scan_plain,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    cs.log(f"[device] {cs.nvidia_smi()} | torch {torch.__version__}")
    t0 = time.perf_counter()
    build.build(["flash_attention", "decode_attention", "ssd_scan"])
    cs.log(f"[build] in {time.perf_counter() - t0:.1f}s")
    for kernel, report in cs.ptxas_by_kernel(
            build.BUILD_LOGS.get("ssd_scan") or "").items():
        cs.log(f"[build] ssd_scan {kernel}: {report}")
    t0 = time.perf_counter()
    cs.ssd_sweep(ssd_scan, ssd_scan_plain, kernel_route)
    cs.ssd_pass_check(
        (ssd_ops.chunk_states, ssd_ops.state_passing, ssd_ops.chunk_outputs),
        (ssd_ref.ssd_chunk_states, ssd_ref.ssd_state_passing,
         ssd_ref.ssd_chunk_outputs))
    cs.log(f"[probe] phase 2's scan parts in {time.perf_counter() - t0:.1f}s")
    cs.cast_bit_check(SMOKE)
    jamba = cs.hybrid_path(dataclasses.replace(JAMBA, **cs.HYBRID_TWO))
    deep = dataclasses.replace(jamba, cfg=dataclasses.replace(
        JAMBA, num_layers=cs.HYBRID_DEEP_LAYERS))
    # one worker of 7 threads: the reference is the only job here
    cs.SERVE_WORKERS, cs.SERVE_WORKER_THREADS = 1, 7
    with cs.serve_pool() as spool:
        t0 = time.perf_counter()
        for _, path, params in cs.prefetched_weights([("4e", jamba)]):
            finish = cs.serve_two_layers(path, params, spool)
        cs.log(f"[probe] 4e on the card in {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        routes = ssd_scan.routes.copy()
        launches = cs.serve_full_depth(deep)
        cs.log(f"[probe] 5e in {time.perf_counter() - t0:.1f}s: launches "
               f"{launches}, routes {dict(ssd_scan.routes - routes)}")
        t0 = time.perf_counter()
        cs.time_ssd(ssd_scan, ssd_scan_plain, cs.SSD_JAMBA, torch.bfloat16,
                    20)
        cs.time_flash(flash_attention, flash_attention_plain, cs.FLASH_JAMBA,
                      torch.bfloat16, 20)
        cs.log(f"[probe] phase 8 rows in {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        finish()
        cs.log(f"[probe] 4e's CPU reference waited {time.perf_counter() - t0:.1f}s")
    cs.log(f"[probe] all in {time.perf_counter() - t_start:.1f}s; "
           f"{len(cs.FAILURES)} failures")
    for what in cs.FAILURES:
        cs.log(f"  FAILED {what}")
    return 1 if cs.FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
