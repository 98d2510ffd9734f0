// Single-query GQA decode attention over a KV cache for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/decode_attention/kernel.py::decode_attention_bkgd (body
// _decode_kernel) together with the reshapes and transposes of its wrapper
// ops.py: this kernel reads q (B, 1, H, hd) and the caches (B, T, KV, hd)
// in the model's own layout and writes out (B, 1, H, hd).
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
// Design. One block of kWarps warps owns one (b, kv head): its G query
// rows share every key and value row the block reads, which is the point
// of the reference's (B, KV, G, hd) layout. Only the keys in [lo, len) are
// read. Each warp walks chunks of 32 keys; lane j computes the G scores of
// key j of the chunk in full (its row is read by that lane alone, through
// L1, with q broadcast from shared memory), so a score needs no cross-lane
// reduction. The chunk's softmax update then costs one max and one sum
// reduction per query row, and one exp per lane and row. For PV, lane j
// owns output columns [j * hd/32, (j+1) * hd/32): it reads that slice of
// each value row (the warp reads the row whole, coalesced) and takes each
// key's probability from its owner lane by a shuffle. The warps' partial
// (m, l, acc) states merge through shared memory at the end. lengths stay
// in device memory: a decode step needs no host round trip.
//
// Bound: bytes. Every key and value row in [lo, len) is read once:
// 2 * B * KV * (len - lo) * hd * sizeof(cache) bytes; at decode_32k's
// shape (B=128, T=32768, KV=4, hd=128, float32 cache, full lengths) that
// is 17.2 GB a layer (8.59 GB each of K and V), 5.13 ms at the H100's
// 3.35 TB/s. With B * KV blocks the card is full only at large batch: the
// serving default (B=4, KV=4) fills 16 of 132 SMs. Splitting the key range
// across blocks (flash-decoding) is the later work that fills it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

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

// four consecutive elements as float32 (16-byte or 8-byte aligned load)
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 c = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, c.x, c.y);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// GMAX bounds G at compile time (register arrays); rows g >= G are idle.
template <typename TQ, typename TC, int HD, int GMAX>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q, const TC* __restrict__ k,
                        const TC* __restrict__ v,
                        const int* __restrict__ lengths,
                        TQ* __restrict__ out, int T_, int KV, int G,
                        int window, float sqrt_hd) {
  constexpr int EPL = HD / 32;   // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                          // G x HD
  float* wm = qs + G * HD;                   // kWarps x G
  float* wl = wm + kWarps * G;               // kWarps x G
  float* wacc = wl + kWarps * G;             // kWarps x G x HD

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = min(max(lengths[b], 0), T_);
  const int lo = window > 0 ? max(len - window, 0) : 0;

  const TQ* qb = q + (int64_t(b) * KV + kh) * G * HD;
  for (int i = threadIdx.x; i < G * HD; i += kThreads) qs[i] = to_f32(qb[i]);
  __syncthreads();

  float m[GMAX], l[GMAX], acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.0f;
  }

  const int64_t row_stride = int64_t(KV) * HD;   // between cache positions
  const TC* kb = k + (int64_t(b) * T_ * KV + kh) * HD;
  const TC* vb = v + (int64_t(b) * T_ * KV + kh) * HD;

  for (int t0 = lo + warp * 32; t0 < len; t0 += kWarps * 32) {
    const int t = t0 + lane;
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.0f;
    if (t < len) {
      const TC* kr = kb + t * row_stride;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        const float4 kx = load4(kr + d);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G) {
            const float4 qx = *reinterpret_cast<const float4*>(qs + g * HD + d);
            s[g] = fmaf(qx.x, kx.x, s[g]);
            s[g] = fmaf(qx.y, kx.y, s[g]);
            s[g] = fmaf(qx.z, kx.z, s[g]);
            s[g] = fmaf(qx.w, kx.w, s[g]);
          }
        }
      }
    }
    float p[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float sg = t < len ? s[g] / sqrt_hd : -INFINITY;
      const float m_new = fmaxf(m[g], warp_max(sg));   // lane 0's key is valid
      const float alpha = expf(m[g] - m_new);
      p[g] = expf(sg - m_new);
      l[g] = l[g] * alpha + warp_sum(p[g]);
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
    }
    const int n = min(32, len - t0);
    for (int j = 0; j < n; ++j) {
      const TC* vr = vb + (t0 + j) * row_stride + lane * EPL;
      float vx[EPL];
      if constexpr (EPL == 4) {
        const float4 x = load4(vr);
        vx[0] = x.x; vx[1] = x.y; vx[2] = x.z; vx[3] = x.w;
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) vx[e] = to_f32(vr[e]);
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float pj = __shfl_sync(0xffffffffu, p[g], j);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pj, vx[e], acc[g][e]);
      }
    }
  }

  // merge the warps' partial states
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      if (lane == 0) {
        wm[warp * G + g] = m[g];
        wl[warp * G + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        wacc[(warp * G + g) * HD + lane * EPL + e] = acc[g][e];
    }
  }
  __syncthreads();
  TQ* ob = out + (int64_t(b) * KV + kh) * G * HD;
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float num = 0.0f, den = 0.0f;
    if (mx != -INFINITY) {
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(wm[w * G + g] - mx);
        num = fmaf(c, wacc[(w * G + g) * HD + d], num);
        den = fmaf(c, wl[w * G + g], den);
      }
    }
    ob[i] = from_f32<TQ>(num / fmaxf(den, 1e-30f));
  }
}

template <typename TQ, typename TC, int HD, int GMAX>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int T_, int KV, int G, int window,
           cudaStream_t stream) {
  const int smem = (G * HD + 2 * kWarps * G + kWarps * G * HD) *
                   static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<TQ, TC, HD, GMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(KV, B);
  decode_attention_kernel<TQ, TC, HD, GMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k),
      static_cast<const TC*>(v), lengths, static_cast<TQ*>(out), T_, KV, G,
      window, sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC, int HD>
int dispatch_g(const void* q, const void* k, const void* v,
               const int* lengths, void* out, int B, int T_, int KV, int G,
               int window, cudaStream_t st) {
  if (G <= 1) return launch<TQ, TC, HD, 1>(q, k, v, lengths, out, B, T_, KV, G, window, st);
  if (G <= 2) return launch<TQ, TC, HD, 2>(q, k, v, lengths, out, B, T_, KV, G, window, st);
  if (G <= 4) return launch<TQ, TC, HD, 4>(q, k, v, lengths, out, B, T_, KV, G, window, st);
  if (G <= 8) return launch<TQ, TC, HD, 8>(q, k, v, lengths, out, B, T_, KV, G, window, st);
  if (G <= 16) return launch<TQ, TC, HD, 16>(q, k, v, lengths, out, B, T_, KV, G, window, st);
  return -1;
}

template <typename TQ, typename TC>
int dispatch_hd(const void* q, const void* k, const void* v,
                const int* lengths, void* out, int B, int T_, int KV, int G,
                int hd, int window, cudaStream_t st) {
  switch (hd) {
    case 32: return dispatch_g<TQ, TC, 32>(q, k, v, lengths, out, B, T_, KV, G, window, st);
    case 64: return dispatch_g<TQ, TC, 64>(q, k, v, lengths, out, B, T_, KV, G, window, st);
    case 128: return dispatch_g<TQ, TC, 128>(q, k, v, lengths, out, B, T_, KV, G, window, st);
    default: return -1;
  }
}

}  // namespace

// C interface, bound with ctypes (kernels/decode_attention/kernel.py).
// q (B, 1, KV * G, hd) and out of q_dtype, k and v (B, T, KV, hd) of
// cache_dtype (0 = float32, 1 = bfloat16; a float32 q takes only a float32
// cache), lengths (B,) int32 in [1, T], all contiguous. hd is 32, 64 or
// 128 and G at most 16. Launches on `stream`; returns cudaGetLastError()
// (0 = launched) or -1 for a shape or type it does not take.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const int* lengths,
                                    void* out, int q_dtype, int cache_dtype,
                                    int B, int T, int KV, int G, int hd,
                                    int window, void* stream) {
  if (B <= 0 || T <= 0 || KV <= 0 || G <= 0) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && cache_dtype == 0)
    return dispatch_hd<float, float>(q, k, v, lengths, out, B, T, KV, G, hd,
                                     window, st);
  if (q_dtype == 1 && cache_dtype == 1)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, lengths, out, B, T, KV, G, hd, window, st);
  if (q_dtype == 1 && cache_dtype == 0)
    return dispatch_hd<__nv_bfloat16, float>(q, k, v, lengths, out, B, T, KV,
                                             G, hd, window, st);
  return -1;
}
