// Float32 building blocks of the flash attention kernels' CUDA-core routes
// (flash_attention.cu's forward, flash_attention_bwd.cu's backward): the
// tile geometry, the 16-byte cp.async loader, the score chain and the
// register-blocked product. Each .cu includes it into its own anonymous
// namespace `simt`, so a kernel's symbols stay private to its library.
//
// A block of kThreads = 128 threads works on tiles of 32 rows of hd floats
// in shared memory, each row padded to hd + 4 floats: a float4 read stays
// 16-byte aligned, and as hd + 4 is an odd number of 16-byte chunks, eight
// consecutive rows start in eight different groups of four banks. Thread
// (ty, tx) = (tid / 8, tid % 8) owns rows ty and ty + 16 of the A side and
// rows tx + 8 j (j < 4) of the B side of a 32 x 32 product, and output
// columns 4 (tx + 8 g) + e (g < hd / 32, e < 4) of its two rows. In a warp
// (four ty by eight tx) every LDS.128 reads either four A rows, which the
// eight lanes of each ty share, or eight consecutive B rows or columns,
// free of bank conflicts. Each FMA of the score tile still reads 3 bytes
// of shared memory (2.5 in the product), against the SM's 128 bytes a
// cycle for its 128 FMAs: the bandwidth, not the banks, bounds the chain.
//
// The score contract: every score s_rc is one thread's fmaf chain over
// d = 0 ... hd - 1 in order, starting from 0.0f (chain_tile), and the
// kernels divide it by sqrt(hd) (not multiply by its inverse). The forward
// and both backward kernels build S and dP with this one function, so the
// backward rebuilds the forward's score bits: in a softmax row saturated to
// one-hot, P is exactly 1 at its maximum and 0 elsewhere, and the D that
// the backward's D kernel sums from its own P dP cancels the dP of its dq
// and dkdv blocks bit for bit (dS = 0, as autograd's softmax backward
// gives).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {
namespace simt {

constexpr int kThreads = 128;   // 16 x 8
constexpr int kRows = 32;       // rows of a tile, both sides of a product
constexpr int kLDP = kRows + 4; // padded row of a P or dS tile

template <int HD>
__host__ __device__ constexpr int ld() {
  return HD + 4;
}

// Floats of one padded 32-row tile of head dim HD.
template <int HD>
__host__ __device__ constexpr int tile_floats() {
  return kRows * ld<HD>();
}

__device__ __forceinline__ bool visible(int row, int col, int S, int T_,
                                        int causal, int window) {
  bool ok = row < S && col < T_;
  if (causal) ok = ok && col <= row;
  if (window > 0) ok = ok && row - col < window;
  return ok;
}

// One 16-byte asynchronous copy into shared memory; with `valid` false it
// reads nothing and writes zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Enqueues rows [r0, r0 + 32) of one head of a (B, seq, heads, HD) float32
// tensor into a padded tile (zeros past `seq`): 8 HD 16-byte copies over
// the block's threads. The caller commits the group.
template <int HD>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int b, int r0, int seq, int heads,
                                          int head) {
  constexpr int kChunks = HD / 4;
  constexpr int LD = ld<HD>();
  static_assert(kRows * kChunks % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int t = 0; t < kRows * kChunks / kThreads; ++t) {
    const int i = threadIdx.x + t * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const int s = r0 + r;
    const bool ok = s < seq;
    const float* g =
        src + ((int64_t(b) * seq + (ok ? s : 0)) * heads + head) * HD + 4 * c;
    cp_async16(dst + r * LD + 4 * c, g, ok);
  }
}

// acc[i][j] = sum_d a[ty + 16 i][d] * b[tx + 8 j][d] over two padded
// tiles: each element one fmaf chain in d order from 0 (the score
// contract). Per four d: 6 LDS.128 and 32 FMAs; U steps of four d a turn
// of the loop.
template <int HD, int U = 4>
__device__ __forceinline__ void chain_tile(float (&acc)[2][4],
                                           const float* a, const float* b) {
  constexpr int LD = ld<HD>();
  static_assert(HD % (4 * U) == 0, "whole turns of the loop");
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const float* ar = a + ty * LD;
  const float* br = b + tx * LD;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 1
  for (int d0 = 0; d0 < HD; d0 += 4 * U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int d = d0 + 4 * u;
      float4 av[2], bv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        av[i] = *reinterpret_cast<const float4*>(ar + 16 * i * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = *reinterpret_cast<const float4*>(br + 8 * j * LD + d);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = acc[i][j];
          x = fmaf(av[i].x, bv[j].x, x);
          x = fmaf(av[i].y, bv[j].y, x);
          x = fmaf(av[i].z, bv[j].z, x);
          x = fmaf(av[i].w, bv[j].w, x);
          acc[i][j] = x;
        }
    }
  }
}

// acc[i][4 g + e] += sum_c p[ty + 16 i][c] * m[c][4 (tx + 8 g) + e] over
// the 32 columns of a kLDP-padded P or dS tile and the 32 rows of a padded
// tile m, c in order. Per four c: 2 + HD / 8 LDS.128 and 4 HD FMAs.
template <int HD>
__device__ __forceinline__ void product_tile(float (&acc)[2][HD / 8],
                                             const float* p, const float* m) {
  constexpr int LD = ld<HD>();
  constexpr int NG = HD / 32;   // float4 column groups a thread
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const float* pr = p + ty * kLDP;
  const float* mc = m + 4 * tx;
#pragma unroll 2
  for (int c = 0; c < kRows; c += 4) {
    float4 pv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      pv[i] = *reinterpret_cast<const float4*>(pr + 16 * i * kLDP + c);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float x[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        x[i] = k == 0 ? pv[i].x : k == 1 ? pv[i].y : k == 2 ? pv[i].z
                                                            : pv[i].w;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 mv =
            *reinterpret_cast<const float4*>(mc + (c + k) * LD + 32 * g);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[i][4 * g] = fmaf(x[i], mv.x, acc[i][4 * g]);
          acc[i][4 * g + 1] = fmaf(x[i], mv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(x[i], mv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(x[i], mv.w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// Writes a thread's columns of one output row, each value times `scale`:
// NG float4 stores to a row of HD floats (16-byte aligned).
template <int HD>
__device__ __forceinline__ void store_row(float* dst, const float* acc,
                                          float scale) {
  const int tx = threadIdx.x % 8;
#pragma unroll
  for (int g = 0; g < HD / 32; ++g)
    *reinterpret_cast<float4*>(dst + 4 * (tx + 8 * g)) =
        make_float4(acc[4 * g] * scale, acc[4 * g + 1] * scale,
                    acc[4 * g + 2] * scale, acc[4 * g + 3] * scale);
}

}  // namespace simt
}  // namespace
