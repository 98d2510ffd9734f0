#!/usr/bin/env python3
"""The flash attention's float32 CUDA kernels rehearsed on the CPU.

Compiles the ``namespace simt`` parts of ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu`` (and ``csrc/simt_tile.cuh``) with the host
C++ compiler, under a small emulation of what they use: a block is 128
host threads, ``__syncthreads`` a barrier, ``__shfl_xor_sync`` a barrier
per warp, shared memory one buffer filled with NaN before each block, and
a ``cp.async`` copy done either when it is issued or only at the
``cp.async.wait_group`` that retires it (both are run, so a ring stage
that is overwritten while read, or read before it landed, shows). The
kernels then run against the port's plain versions (``ref.py``) at small
shapes: every hd, G up to 8, ragged S, windows, non-causal T > S for the
forward; lse, the forward with and without lse bit-equal, reruns
bit-equal, and softmax rows saturated to one-hot (scores near 1e7 and
1e11), whose gradient needs the backward to rebuild the forward's score
bits. It says nothing of speed, and nothing of what nvcc accepts.

    python3 scripts/simt_rehearsal.py          # ~1 min, needs g++ (C++20)

Exits non-zero when a check failed.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "simt_rehearsal"

PRELUDE = r'''
#pragma once
#include <math.h>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <barrier>
#include <thread>
#include <vector>
#include <memory>
#include <algorithm>
using std::min; using std::max;
struct dim3 { unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __shared__
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
constexpr int kSmemFloats = 65536;
template <class F> int cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return bytes <= 4 * kSmemFloats ? 0 : 1;
}
inline int cudaGetLastError() { return 0; }
inline std::barrier<>* g_block = nullptr;
inline void __syncthreads() { g_block->arrive_and_wait(); }
struct Warp { std::unique_ptr<std::barrier<>> bar; float buf[32]; };
inline std::vector<Warp>* g_warps = nullptr;
inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int t = threadIdx.x; Warp& w = (*g_warps)[t / 32];
  w.buf[t % 32] = v; w.bar->arrive_and_wait();
  const float r = w.buf[(t % 32) ^ o]; w.bar->arrive_and_wait();
  return r;
}
inline int g_late = 0;   // 0: a copy lands when issued; 1: at its wait
struct Copy { float* dst; const float* src; bool valid; };
inline thread_local std::vector<std::vector<Copy>> t_groups;
inline thread_local std::vector<Copy> t_open;
inline void do_copy(const Copy& c) {
  if (c.valid) std::memcpy(c.dst, c.src, 16); else std::memset(c.dst, 0, 16);
}
inline void emu_cp_async16(float* dst, const float* src, bool valid) {
  if ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) % 16) {
    std::fprintf(stderr, "misaligned cp.async\n"); std::abort();
  }
  const Copy c{dst, src, valid};
  if (g_late) t_open.push_back(c); else do_copy(c);
}
inline void emu_commit() { t_groups.push_back(t_open); t_open.clear(); }
inline void emu_wait(int n) {
  while (static_cast<int>(t_groups.size()) > n) {
    for (auto& c : t_groups.front()) do_copy(c);
    t_groups.erase(t_groups.begin());
  }
}
namespace { namespace simt { alignas(16) float4 smem_f4[kSmemFloats / 4]; } }
template <class F>
void emu_launch(dim3 grid, int threads, int smem_bytes, F f) {
  if (smem_bytes > 4 * kSmemFloats) { std::fprintf(stderr, "smem\n"); std::abort(); }
  float* smem = reinterpret_cast<float*>(simt::smem_f4);
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::fill(smem, smem + kSmemFloats, NAN);
        std::barrier<> block(threads);
        std::vector<Warp> warps(threads / 32);
        for (auto& w : warps) w.bar = std::make_unique<std::barrier<>>(32);
        g_block = &block; g_warps = &warps; gridDim = grid; blockDim = dim3(threads);
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([&, t] {
            threadIdx = dim3(t); blockIdx = dim3(x, y, z);
            t_groups.clear(); t_open.clear();
            f();
          });
        for (auto& t : ts) t.join();
      }
}
'''

API = {
    "flash_attention.cu": r'''
extern "C" int rehearse(const float* q, const float* k, const float* v, float* out,
                        float* lse, int B, int S, int T, int H, int KV, int hd,
                        int causal, int window, int late) {
  g_late = late;
  switch (hd) {
#define CASE(D) case D: return simt::launch<D>(q, k, v, out, lse, B, S, T, H, KV, causal, window, nullptr);
    CASE(32) CASE(64) CASE(128) CASE(160)
  }
  return -1;
}''',
    "flash_attention_bwd.cu": r'''
extern "C" int rehearse(const float* q, const float* k, const float* v, const float* dout,
                        const float* lse, float* delta, float* dq, float* dk, float* dv,
                        int B, int S, int T, int H, int KV, int hd, int causal,
                        int window, int late) {
  g_late = late;
  switch (hd) {
#define CASE(D) case D: return simt::launch<D>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, T, H, KV, causal, window, nullptr);
    CASE(32) CASE(64) CASE(128) CASE(160)
  }
  return -1;
}''',
}


def _closing(text: str, i: int, pair: str) -> int:
    """Index of the bracket closing the one at ``i``."""
    depth = 0
    for j in range(i, len(text)):
        depth += {pair[0]: 1, pair[1]: -1}.get(text[j], 0)
        if depth == 0:
            return j
    raise ValueError("unbalanced")


def _replace_body(text: str, signature: str, body: str) -> str:
    i = text.index("{", text.index(signature))
    return text[:i] + body + text[_closing(text, i, "{}") + 1:]


def _split_top(cfg: str):
    parts, depth, cur = [], 0, ""
    for ch in cfg:
        depth += {"(": 1, ")": -1}.get(ch, 0)
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return parts + [cur.strip()]


def _launches(text: str) -> str:
    """``kernel<HD><<<grid, threads, smem, stream>>>(args)`` as an
    ``emu_launch`` of a lambda."""
    out, pos = [], 0
    while (i := text.find("<<<", pos)) >= 0:
        name = re.search(r"([\w:]+<\w+>)$", text[:i])
        j = text.index(">>>", i)
        grid, threads, smem, _ = _split_top(text[i + 3:j])
        k = text.index("(", j)
        e = _closing(text, k, "()")
        out += [text[pos:name.start(1)],
                f"emu_launch({grid}, {threads}, {smem}, [&] {{ "
                f"{name.group(1)}({text[k + 1:e]}); }})"]
        pos = e + 1
    return "".join(out) + text[pos:]


def build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "prelude.h").write_text(PRELUDE)
    hdr = (CSRC / "simt_tile.cuh").read_text().replace(
        "#include <cuda_runtime.h>", "")
    hdr = _replace_body(hdr, "void cp_async16(",
                        "{ emu_cp_async16(dst, src, valid); }")
    hdr = _replace_body(hdr, "void cp_async_commit(", "{ emu_commit(); }")
    hdr = _replace_body(hdr, "void cp_async_wait(", "{ emu_wait(N); }")
    (OUT / "simt_tile.h").write_text(hdr)
    libs = {}
    for src, api in API.items():
        text = (CSRC / src).read_text()
        a = text.index("namespace simt {")
        b = text.index("}  // namespace simt") + len("}  // namespace simt")
        cpp = OUT / src.replace(".cu", ".cpp")
        cpp.write_text('#include "prelude.h"\n#include "simt_tile.h"\n'
                       "namespace {\n" + _launches(text[a:b]) + "\n}\n" + api)
        lib = cpp.with_suffix(".so")
        subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared",
                        "-pthread", "-ffp-contract=off", "-Wall",
                        "-Wno-unknown-pragmas", "-Wno-unused-function",
                        "-I", str(OUT), str(cpp), "-o", str(lib)], check=True)
        libs[src] = ctypes.CDLL(str(lib))
    libs["flash_attention.cu"].rehearse.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9)
    libs["flash_attention_bwd.cu"].rehearse.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9)
    return libs


CASES = [  # b, s, t, h, kv, hd, causal, window
    (2, 64, 64, 4, 2, 32, True, 0),
    (1, 100, 100, 4, 2, 64, True, 0),       # ragged S
    (1, 70, 70, 8, 1, 128, True, 0),        # G = 8
    (1, 45, 45, 2, 2, 160, True, 0),
    (1, 130, 130, 2, 1, 64, True, 48),      # a window inside a tile
    (1, 100, 100, 4, 1, 32, True, 20),
    (2, 50, 50, 4, 2, 64, False, 0),
    (1, 80, 80, 2, 2, 128, False, 30),
    (1, 75, 75, 8, 1, 64, True, 33),
    (1, 40, 40, 4, 4, 160, True, 17),
    (2, 20, 100, 4, 2, 64, False, 0),       # T > S: the forward only
    (1, 33, 70, 2, 1, 160, False, 0),
]
SATURATED = [  # b, s, h, kv, hd, window
    (2, 100, 4, 2, 64, 0), (1, 90, 8, 1, 64, 0), (1, 75, 2, 2, 32, 20),
    (1, 70, 4, 2, 128, 0), (1, 50, 2, 1, 160, 9)]


def main() -> int:
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    from repro_torch.kernels.flash_attention.ref import (
        attention_lse_plain, flash_attention_bwd_plain,
    )

    t0 = time.perf_counter()
    libs = build()
    fwd_lib, bwd_lib = libs["flash_attention.cu"], libs["flash_attention_bwd.cu"]
    failures = []

    def fwd(q, k, v, causal, window, late, with_lse=True):
        (B, S, H, hd), (T, KV) = q.shape, k.shape[1:3]
        out = torch.full_like(q, float("nan"))
        lse = torch.full((B, H, S), float("nan")) if with_lse else None
        rc = fwd_lib.rehearse(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(),
                              lse.data_ptr() if with_lse else None, B, S, T,
                              H, KV, hd, int(causal), window, late)
        assert rc == 0, rc
        return out, lse

    def bwd(q, k, v, do, lse, causal, window, late):
        (B, S, H, hd), (T, KV) = q.shape, k.shape[1:3]
        grads = [torch.full_like(x, float("nan")) for x in (q, k, v)]
        delta = torch.full((B, H, S), float("nan"))
        rc = bwd_lib.rehearse(*(x.data_ptr() for x in (q, k, v, do, lse)),
                              delta.data_ptr(),
                              *(g.data_ptr() for g in grads), B, S, T, H, KV,
                              hd, int(causal), window, late)
        assert rc == 0, rc
        return grads

    def inputs(seed, b, s, t, h, kv, hd):
        rng = np.random.default_rng(seed)
        return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd),
                              (b, s, h, hd))]

    def rel(got, want):
        return float((got.double() - want).abs().max()
                     / want.abs().max().clamp_min(1e-30))

    worst = {"forward": 0.0, "lse": 0.0, "backward": 0.0}
    for late in (0, 1):
        for i, (b, s, t, h, kv, hd, causal, window) in enumerate(CASES):
            q, k, v, do = inputs(i, b, s, t, h, kv, hd)
            out, lse = fwd(q, k, v, causal, window, late)
            bare, _ = fwd(q, k, v, causal, window, late, with_lse=False)
            err = float((out - flash_attention_plain(
                q, k, v, causal=causal, window=window)).abs().max())
            lse_err = float((lse - attention_lse_plain(
                q, k, causal=causal, window=window)).abs().max())
            worst["forward"] = max(worst["forward"], err)
            worst["lse"] = max(worst["lse"], lse_err)
            if err > 1e-5 or lse_err > 1e-4 or not torch.equal(out, bare):
                failures.append(f"forward {CASES[i]} late={late}: {err}, "
                                f"lse {lse_err}")
            if t != s:
                continue
            got = bwd(q, k, v, do, lse, causal, window, late)
            exact = flash_attention_bwd_plain(q, k, v, do, causal=causal,
                                              window=window,
                                              dtype=torch.float64)
            r = max(rel(g, e) for g, e in zip(got, exact))
            worst["backward"] = max(worst["backward"], r)
            again = bwd(q, k, v, do, lse, causal, window, late)
            if r > 1e-4 or not all(torch.equal(a, g)
                                   for a, g in zip(again, got)):
                failures.append(f"backward {CASES[i]} late={late}: {r}")
    for scale in (3e3, 3e5):
        for case in SATURATED:
            b, s, h, kv, hd, window = case
            q, k, v, do = inputs(3, b, s, s, h, kv, hd)
            q, k = q * scale, k * scale
            _, lse = fwd(q, k, v, True, window, 1)
            got = bwd(q, k, v, do, lse, True, window, 1)
            want = flash_attention_bwd_plain(q, k, v, do, causal=True,
                                             window=window)
            for g, w in zip(got, want):
                bound = 1e-4 * max(1.0, float(w.abs().max()))
                if not (bool(g.isfinite().all())
                        and float((g - w).abs().max()) <= bound):
                    failures.append(f"saturated {case} x{scale}: "
                                    f"{float((g - w).abs().max())}")
    print(f"[rehearsal] {2 * len(CASES)} forward and "
          f"{2 * sum(c[1] == c[2] for c in CASES)} backward cases, "
          f"{2 * len(SATURATED)} saturated; worst: forward "
          f"{worst['forward']:.3e} (bound 1e-5), lse {worst['lse']:.3e}, "
          f"backward {worst['backward']:.3e} relative to float64 (bound "
          f"1e-4); {time.perf_counter() - t0:.1f}s")
    for what in failures:
        print(f"  FAILED {what}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
