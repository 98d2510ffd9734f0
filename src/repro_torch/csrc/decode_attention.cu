// Single-query GQA decode attention over a KV cache for Hopper (sm_90a),
// split over the keys (flash-decoding).
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/decode_attention/kernel.py::decode_attention_bkgd (body
// _decode_kernel) together with the reshapes and transposes of its wrapper
// ops.py: the kernels read q (B, 1, H, hd) and the caches (B, T, KV, hd)
// in the model's own layout and write out (B, 1, H, hd).
//
// For sequence b, kv head kh and its G = H / KV query heads
// (h = kh * G + g), with len = lengths[b]:
//   s_t = (q_g . k_t) / sqrt(hd)   over lo <= t < len,
//         lo = window > 0 ? max(len - window, 0) : 0
//   out_g = sum_t softmax(s)_t v_t
// in float32. q (and out) and the caches are typed separately, each
// float32 or bfloat16: the serving path keeps bfloat16 activations over a
// float32 cache.
//
// Bound: bytes. Every key and value row in [lo, len) is read once:
// 2 * B * KV * (len - lo) * hd * sizeof(cache) bytes, about 4 flops a byte
// over a float32 cache (8 over bfloat16), far under the CUDA cores' ridge,
// so no tensor cores are needed: the design goal is bytes in flight. At
// decode_32k's shape (B=128, T=32768, KV=4, hd=128, float32 cache, full
// lengths) that is 17.2 GB a layer, 5.13 ms at the H100's 3.35 TB/s; at
// B=1 it is 134 MB, 0.040 ms.
//
// Design. The Pallas kernel carries one online-softmax state along a
// sequential grid axis over key blocks. Here that axis becomes S parallel
// blocks and a merge:
// - Split. The grid is (S, KV, B). The wrapper picks S from the shapes
//   and the SM count only (ops.num_splits), never from lengths, so a step
//   makes no host round trip. Each block reads lengths[b] on the card and
//   takes its share of the live range [lo, len): the range cut evenly into
//   S, rounded up to whole tiles of kTileKeys keys. The live keys of a
//   step thus spread over all S blocks; a block left with no keys writes
//   the empty state (m = -inf, l = 0, acc = 0).
// - Ring. A block stages its keys' K and V rows, a tile at a time, into a
//   ring of shared-memory stages with 16-byte cp.async (zero-filled past
//   the block's last key), and keeps all stages but one in flight while it
//   computes on the tile that has arrived: bytes in flight, not one
//   dependent load per key. A float32 hd-128 ring holds 6 tiles (96 KB),
//   so a T = 48 slab (48 KB) is requested at once and a long split keeps
//   80 KB in flight; a float32 hd-160 ring holds 4 tiles (80 KB). A block
//   takes kBlockSmem whatever its ring uses, so exactly two blocks share
//   an SM and the grid runs in waves of 2 * SMs blocks, which the split
//   rule counts in (at decode_32k's B = 128, 512 blocks are 1.94 waves of
//   264; three blocks an SM made them 1.29 waves of 396, whose tail left
//   the card a third idle).
// - Compute. Each warp takes groups of KPW keys of a tile. Lane j holds
//   columns [j * hd/32, (j+1) * hd/32) of every query row in registers and
//   reads the same columns of each key row from shared memory once for all
//   G rows. The G * KPW partial dot products are summed across the warp by
//   a halving exchange (each step sends half of the values and keeps the
//   other half), after which lane j holds one full (key, row) score; the
//   online-softmax update runs on those, and PV takes each probability
//   from its owner lane by a shuffle. The warps' states merge through
//   shared memory at the end of the block.
// - Combine. With S > 1 each block writes its float32 partial (acc, m, l)
//   to a scratch (B, KV, S, G, hd + 2) that the wrapper allocates, and a
//   second kernel merges the S partials of each (b, kh, g) by the
//   log-sum-exp rule: out = sum_s e^(m_s - m) acc_s / sum_s e^(m_s - m) l_s,
//   m = max_s m_s, an empty split weighing e^-inf = 0. With S = 1 the
//   split kernel normalises and writes out itself; no combine runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileKeys = 16;   // keys a stage of the ring holds
// Shared memory a split block takes: two blocks share an SM (of its
// 228 KB), so the wrapper's split rule counts in waves of 2 * SMs blocks.
constexpr int kBlockSmem = 96 * 1024;
constexpr int kMaxSplits = 4096;
constexpr int kCombineThreads = 256;

// Ring depth: as many stages as kBlockSmem holds, at most 16; while a block
// computes on one stage, the others are in flight (80 KB of a float32
// hd-128 cache).
template <typename TC, int HD>
__host__ __device__ constexpr int ring_stages() {
  constexpr int n = kBlockSmem / (2 * kTileKeys * HD * int(sizeof(TC)));
  return n < 16 ? n : 16;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N consecutive elements of a shared-memory row as float32. A lane's N
// columns start at lane * N: 16-, 8- or 4-byte vectors for N = 4, 2, 1;
// at hd = 160 (N = 5) they start 20 bytes apart (10 in bfloat16), which
// no vector load fits, so each element is read alone (lanes 5 floats
// apart hit 32 distinct banks).
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}
template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&x)[N]) {
  if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 c = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    x[0] = a.x; x[1] = a.y; x[2] = c.x; x[3] = c.y;
  } else if constexpr (N == 2) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    x[0] = a.x; x[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = __bfloat162float(p[i]);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the newest N groups of this thread's copies have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage the K and V rows of keys [t0, t0 + kTileKeys) into one stage of
// the ring (K tile, then V tile, each kTileKeys x HD); rows at or past
// `end` are zeros.
template <typename TC, int HD>
__device__ __forceinline__ void stage_tile(const TC* kb, const TC* vb,
                                           int64_t row_stride, int t0,
                                           int end, TC* stage) {
  constexpr int kPer = 16 / sizeof(TC);      // elements a 16-byte copy
  constexpr int kChunks = HD / kPer;         // copies a row
  for (int i = threadIdx.x; i < 2 * kTileKeys * kChunks; i += kThreads) {
    const int which = i / (kTileKeys * kChunks);          // 0: K, 1: V
    const int r = (i / kChunks) % kTileKeys, c = i % kChunks;
    const bool live = t0 + r < end;
    const TC* src = (which ? vb : kb) +
                    (live ? (t0 + r) * row_stride + c * kPer : 0);
    cp_async16(smem_u32(stage + (which * kTileKeys + r) * HD + c * kPer),
               src, live ? 16u : 0u);
  }
}

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

// Halving exchange of a warp's N0 values s[0, N0), one step per halving:
// at the step over N values, of lane offset o = 16 * N / N0, lanes with
// bit o set keep the upper half of their values and send the lower half
// to lane ^ o, the others the reverse, and each adds what it receives.
// After the last step lane j holds in s[0] value j >> (5 - log2 N0),
// summed over the lanes that share j's low 5 - log2 N0 bits. One template
// instance a step, so that every index is a constant and s stays in
// registers.
template <int N0, int N>
__device__ __forceinline__ void halve(float (&s)[N0], int lane) {
  if constexpr (N > 1) {
    constexpr int half = N / 2, off = 16 * N / N0;
    const bool upper = lane & off;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float send = upper ? s[j] : s[j + half];
      const float keep = upper ? s[j + half] : s[j];
      s[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    halve<N0, half>(s, lane);
  }
}

// GMAX bounds G at compile time (register arrays; a power of two); rows
// g >= G hold zeros and are not written.
template <typename TQ, typename TC, int HD, int GMAX>
__global__ void __launch_bounds__(kThreads, 2)
decode_split_kernel(const TQ* __restrict__ q, const TC* __restrict__ k,
                    const TC* __restrict__ v, const int* __restrict__ lengths,
                    TQ* __restrict__ out, float* __restrict__ part, int T_,
                    int KV, int G, int window, int S, float sqrt_hd) {
  constexpr int EPL = HD / 32;                     // columns a lane
  static_assert(HD % 32 == 0, "hd must be a multiple of 32");
  constexpr int KPW = 32 / GMAX < kTileKeys / kWarps ? 32 / GMAX
                                                     : kTileKeys / kWarps;
  constexpr int NV = KPW * GMAX;        // (key, row) scores a warp reduces
  constexpr int LOG_NV = ilog2(NV), LOG_G = ilog2(GMAX);
  constexpr int SHIFT = 5 - LOG_NV;     // lane = v << SHIFT | replica
  constexpr int GROUPS = kTileKeys / KPW;
  constexpr int STAGE = 2 * kTileKeys * HD;        // elements a stage
  constexpr int kStages = ring_stages<TC, HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  TC* ring = reinterpret_cast<TC*>(smem);

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row_stride = int64_t(KV) * HD;   // between cache positions
  const TC* kb = k + (int64_t(b) * T_ * KV + kh) * HD;
  const TC* vb = v + (int64_t(b) * T_ * KV + kh) * HD;
  const int len = min(max(lengths[b], 0), T_);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  // this block's share of [lo, len): cut evenly, rounded up to whole tiles
  const int share =
      ((len - lo + S - 1) / S + kTileKeys - 1) / kTileKeys * kTileKeys;
  const int start = lo + split * share;
  const int end = min(start + share, len);
  const int ntiles = start < end ? (end - start + kTileKeys - 1) / kTileKeys
                                 : 0;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ntiles)
      stage_tile<TC, HD>(kb, vb, row_stride, start + i * kTileKeys, end,
                         ring + i * STAGE);
    cp_async_commit();
  }

  float qr[GMAX][EPL], acc[GMAX][EPL];
  const TQ* qb = q + (int64_t(b) * KV + kh) * G * HD + lane * EPL;
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[g][e] = g < G ? to_f32(qb[g * HD + e]) : 0.0f;
      acc[g][e] = 0.0f;
    }
  // the running state of the row this lane's score belongs to
  const int own_key = (lane >> SHIFT) >> LOG_G;    // key within a group
  float m_own = -INFINITY, l_own = 0.0f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    // tile i has landed for every thread, and every warp is done with
    // tile i - 1, whose stage the next copy refills
    __syncthreads();
    if (i + kStages - 1 < ntiles)
      stage_tile<TC, HD>(kb, vb, row_stride,
                         start + (i + kStages - 1) * kTileKeys, end,
                         ring + ((i + kStages - 1) % kStages) * STAGE);
    cp_async_commit();
    const TC* ks = ring + (i % kStages) * STAGE;
    const TC* vs = ks + kTileKeys * HD;
    const int t_tile = start + i * kTileKeys;
    for (int grp = warp; grp < GROUPS; grp += kWarps) {
      const int k0 = grp * KPW;
      if (t_tile + k0 >= end) break;             // the group's first key
      // this lane's columns of q_g . k_t for the group's keys and every row
      float s[NV];
#pragma unroll
      for (int kk = 0; kk < KPW; ++kk) {
        float kx[EPL];
        load_row(ks + (k0 + kk) * HD + lane * EPL, kx);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          float a = 0.0f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) a = fmaf(qr[g][e], kx[e], a);
          s[kk * GMAX + g] = a;
        }
      }
      halve<NV, NV>(s, lane);          // then sum over the replicas
#pragma unroll
      for (int off = 16 >> LOG_NV; off > 0; off >>= 1)
        s[0] += __shfl_xor_sync(0xffffffffu, s[0], off);
      // lane holds the score of key own_key of the group, row
      // (lane >> SHIFT) % GMAX; the group's keys of a row differ in the
      // lane bits from 32 / KPW up
      const float sc = t_tile + k0 + own_key < end ? s[0] / sqrt_hd
                                                   : -INFINITY;
      float gm = sc;
#pragma unroll
      for (int off = 16; off >= 32 / KPW; off >>= 1)
        gm = fmaxf(gm, __shfl_xor_sync(0xffffffffu, gm, off));
      const float m_new = fmaxf(m_own, gm);      // finite: key k0 is live
      const float alpha = expf(m_own - m_new);
      const float p = expf(sc - m_new);
      float ps = p;
#pragma unroll
      for (int off = 16; off >= 32 / KPW; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l_own = l_own * alpha + ps;
      m_own = m_new;
      // PV: each row's rescale and each (key, row) probability from the
      // lane that holds it
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float al = __shfl_sync(0xffffffffu, alpha, g << SHIFT);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= al;
      }
#pragma unroll
      for (int kk = 0; kk < KPW; ++kk) {
        float vx[EPL];
        load_row(vs + (k0 + kk) * HD + lane * EPL, vx);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          const float pk =
              __shfl_sync(0xffffffffu, p, (kk * GMAX + g) << SHIFT);
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pk, vx[e], acc[g][e]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                        // the ring becomes the merge area

  // merge the warps' states (a warp without keys holds -inf, 0, 0)
  float* wm = reinterpret_cast<float*>(smem);      // kWarps x GMAX
  float* wl = wm + kWarps * GMAX;                  // kWarps x GMAX
  float* wc = wl + kWarps * GMAX;                  // kWarps x GMAX weights
  float* rows = wc + kWarps * GMAX;                // GMAX x (m, l, 1 / l)
  float* wacc = rows + 3 * GMAX;                   // kWarps x GMAX x HD
  if (own_key == 0 && (lane & ((1 << SHIFT) - 1)) == 0) {
    const int g = lane >> SHIFT;
    wm[warp * GMAX + g] = m_own;
    wl[warp * GMAX + g] = l_own;
  }
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      wacc[(warp * GMAX + g) * HD + lane * EPL + e] = acc[g][e];
  __syncthreads();
  if (threadIdx.x < G) {                 // a row's weights, once
    const int g = threadIdx.x;
    float mx = -INFINITY, den = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * GMAX + g]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = mx == -INFINITY ? 0.0f : expf(wm[w * GMAX + g] - mx);
      wc[w * GMAX + g] = c;
      den = fmaf(c, wl[w * GMAX + g], den);
    }
    rows[3 * g] = mx;
    rows[3 * g + 1] = den;
    rows[3 * g + 2] = 1.0f / fmaxf(den, 1e-30f);
  }
  __syncthreads();
  const int64_t row0 = (int64_t(b) * KV + kh) * G;   // (b, kh, g = 0)
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float num = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      num = fmaf(wc[w * GMAX + g], wacc[(w * GMAX + g) * HD + d], num);
    if (part == nullptr) {
      out[row0 * HD + i] = from_f32<TQ>(num * rows[3 * g + 2]);
    } else {
      float* pr = part + ((row0 * S + int64_t(split) * G) + g) * (HD + 2);
      pr[d] = num;
      if (d == 0) {
        pr[HD] = rows[3 * g];
        pr[HD + 1] = rows[3 * g + 1];
      }
    }
  }
}

// Block-wide max / sum over kCombineThreads threads; every thread gets the
// result. `red` holds one value a warp.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  __syncthreads();                  // red is free (an earlier reduction)
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kCombineThreads / 32; ++w)
    x = kMax ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// Merge the S partials of (b, kh, g = blockIdx.x) into out's row:
// weights c_s = e^(m_s - m) of every split in parallel (0 for an empty
// split), then thread (j, d) sums c_s acc_s[d] over the splits
// s = j (mod kGroups), with the loads of several splits in flight. At
// hd = 160 kGroups is 1 and threads 160-255 only join the barriers.
template <typename TQ, int HD>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ part, TQ* __restrict__ out,
                      int KV, int G, int S) {
  constexpr int kGroups = kCombineThreads / HD;
  static_assert(kGroups >= 1);
  extern __shared__ float cs[];            // S weights, then kGroups x HD
  __shared__ float red[kCombineThreads / 32];
  const int g = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int64_t stride = int64_t(G) * (HD + 2);   // between splits
  const float* pr = part + ((int64_t(b) * KV + kh) * S * G + g) * (HD + 2);
  float mx = -INFINITY;
  for (int s = threadIdx.x; s < S; s += kCombineThreads)
    mx = fmaxf(mx, pr[s * stride + HD]);
  mx = block_reduce<true>(mx, red);
  float den = 0.0f;
  for (int s = threadIdx.x; s < S; s += kCombineThreads) {
    const float c = mx == -INFINITY ? 0.0f : expf(pr[s * stride + HD] - mx);
    cs[s] = c;
    den = fmaf(c, pr[s * stride + HD + 1], den);
  }
  den = block_reduce<false>(den, red);     // its barriers publish cs
  const int j = threadIdx.x / HD, d = threadIdx.x % HD;
  const bool summing = j < kGroups;
  float num = 0.0f;
  float* sums = cs + S;
  if (summing) {
#pragma unroll 8
    for (int s = j; s < S; s += kGroups)
      num = fmaf(cs[s], pr[s * stride + d], num);
    sums[j * HD + d] = num;
  }
  __syncthreads();
  if (j == 0) {
#pragma unroll
    for (int i = 1; i < kGroups; ++i) num += sums[i * HD + d];
    out[((int64_t(b) * KV + kh) * G + g) * HD + d] =
        from_f32<TQ>(num / fmaxf(den, 1e-30f));
  }
}

template <typename TQ, typename TC, int HD, int GMAX>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, float* part, int B, int T_, int KV, int G, int window,
           int S, cudaStream_t stream) {
  // the ring and, after it, the warps' merge fit kBlockSmem
  static_assert(ring_stages<TC, HD>() >= 2);
  static_assert((3 * kWarps * GMAX + 3 * GMAX + kWarps * GMAX * HD) *
                    sizeof(float) <= kBlockSmem);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<TQ, TC, HD, GMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBlockSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_split_kernel<TQ, TC, HD, GMAX><<<dim3(S, KV, B), kThreads,
                                          kBlockSmem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), lengths, static_cast<TQ*>(out),
      S == 1 ? nullptr : part, T_, KV, G, window, S,
      sqrtf(static_cast<float>(HD)));
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  const int smem = (S + kCombineThreads) * static_cast<int>(sizeof(float));
  decode_combine_kernel<TQ, HD><<<dim3(G, KV, B), kCombineThreads, smem,
                                  stream>>>(part, static_cast<TQ*>(out), KV,
                                            G, S);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC, int HD>
int dispatch_g(const void* q, const void* k, const void* v,
               const int* lengths, void* out, float* part, int B, int T_,
               int KV, int G, int window, int S, cudaStream_t st) {
  if (G <= 1) return launch<TQ, TC, HD, 1>(q, k, v, lengths, out, part, B, T_, KV, G, window, S, st);
  if (G <= 2) return launch<TQ, TC, HD, 2>(q, k, v, lengths, out, part, B, T_, KV, G, window, S, st);
  if (G <= 4) return launch<TQ, TC, HD, 4>(q, k, v, lengths, out, part, B, T_, KV, G, window, S, st);
  if (G <= 8) return launch<TQ, TC, HD, 8>(q, k, v, lengths, out, part, B, T_, KV, G, window, S, st);
  if (G <= 16) return launch<TQ, TC, HD, 16>(q, k, v, lengths, out, part, B, T_, KV, G, window, S, st);
  return -1;
}

template <typename TQ, typename TC>
int dispatch_hd(const void* q, const void* k, const void* v,
                const int* lengths, void* out, float* part, int B, int T_,
                int KV, int G, int hd, int window, int S, cudaStream_t st) {
  switch (hd) {
    case 32: return dispatch_g<TQ, TC, 32>(q, k, v, lengths, out, part, B, T_, KV, G, window, S, st);
    case 64: return dispatch_g<TQ, TC, 64>(q, k, v, lengths, out, part, B, T_, KV, G, window, S, st);
    case 128: return dispatch_g<TQ, TC, 128>(q, k, v, lengths, out, part, B, T_, KV, G, window, S, st);
    case 160: return dispatch_g<TQ, TC, 160>(q, k, v, lengths, out, part, B, T_, KV, G, window, S, st);
    default: return -1;
  }
}

}  // namespace

// C interface, bound with ctypes (kernels/decode_attention/kernel.py).
// q (B, 1, KV * G, hd) and out of q_dtype, k and v (B, T, KV, hd) of
// cache_dtype (0 = float32, 1 = bfloat16; a float32 q takes only a float32
// cache), lengths (B,) int32 in [1, T], all contiguous and 16-byte
// aligned. hd is 32, 64, 128 or 160, G at most 16, B at most 65535 (the
// grid's z). `splits` (S, 1 to 4096) blocks share each (b, kv head); with
// S > 1, `partials` is a float32 scratch (B, KV, S, G, hd + 2) and a
// combine kernel follows the split kernel. Launches on `stream`; returns
// cudaGetLastError() (0 = launched) or -1 for a shape or type it does not
// take.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const int* lengths,
                                    void* out, void* partials, int q_dtype,
                                    int cache_dtype, int B, int T, int KV,
                                    int G, int hd, int window, int splits,
                                    void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || KV <= 0 || G <= 0 || splits < 1 ||
      splits > kMaxSplits || (splits > 1 && partials == nullptr))
    return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  if (q_dtype == 0 && cache_dtype == 0)
    return dispatch_hd<float, float>(q, k, v, lengths, out, part, B, T, KV,
                                     G, hd, window, splits, st);
  if (q_dtype == 1 && cache_dtype == 1)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, lengths, out, part, B, T, KV, G, hd, window, splits, st);
  if (q_dtype == 1 && cache_dtype == 0)
    return dispatch_hd<__nv_bfloat16, float>(q, k, v, lengths, out, part, B,
                                             T, KV, G, hd, window, splits,
                                             st);
  return -1;
}
