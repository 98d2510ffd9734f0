"""Build the port's CUDA kernels from the repository's own sources.

Each ``csrc/<name>.cu`` holds one kernel behind a plain C interface. It is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the repository root and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. Libraries are named by a hash
of their source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source or header rebuilds and an unchanged one is reused. Nothing
is imported or compiled until a kernel is first needed: the CPU tests
import every module of the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")

_LOADED: Dict[str, ctypes.CDLL] = {}   # per-process cache of loaded libraries
BUILD_LOGS: Dict[str, str] = {}        # nvcc/ptxas output of this process's builds


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels build only on a "
        "machine with the CUDA toolkit")


def cuda_tool(name: str) -> str:
    """A program of the CUDA toolkit that holds nvcc, e.g. ``cuobjdump``."""
    return str(Path(_nvcc()).with_name(name))


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library is built: named by a hash of the
    source, every ``csrc/*.cuh`` header it may include, and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named source that has no current library, all nvcc
    processes at once; raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LOADED:
        path = build([name])[name]
        _LOADED[name] = ctypes.CDLL(str(path))
    return _LOADED[name]
