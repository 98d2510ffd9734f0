// Blockwise causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/flash_attention/kernel.py::flash_attention_bhsd (body
// _flash_kernel) together with the transposes of its wrapper ops.py: this
// kernel reads q (B, S, H, hd) and k, v (B, T, KV, hd) in the model's own
// layout and writes out (B, S, H, hd), so no transpose is materialized.
//
// For each query row r and head h (kv head h / (H / KV)):
//   s_c = (q_r . k_c) / sqrt(hd)   over the keys c with c < T and,
//         when causal, c <= r and, when window > 0, r - c < window
//   out_r = sum_c softmax(s)_c v_c
// in float32 whatever the input type (float32 or bfloat16); out is
// rounded to the input type once at the end.
//
// Design. One block of 256 threads owns one (b, h, 64-row query tile). The
// TPU kernel's sequential kv grid axis becomes a loop inside the block
// over 64-key tiles, each staged through shared memory as float32. The
// online-softmax state (row max m, row sum l, the 64 x hd accumulator)
// lives in registers: thread (ty, tx) of the 16 x 16 layout owns rows
// ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and output columns
// tx + 16 j (j < hd / 16); a row's statistics reduce over the 16 lanes of
// its half-warp with shuffles. Tiles wholly above the causal diagonal or
// before the window are never loaded. Rows past S (a ragged last tile) are
// masked here, not padded by the caller. Shared-memory rows of q and k are
// padded to hd + 1 floats so the 16 lanes reading 16 key rows hit 16 banks.
//
// Bound: operations. A causal self-attention over S tokens does about
// 4 B H hd S (S + 1) / 2 flops (QK^T and PV, upper triangle skipped); for
// yi-9b's prefill at B=1, S=4096, H=32, hd=128 that is 137 GFLOP a layer,
// 0.139 ms at the H100's 989 TFLOP/s bf16 tensor-core rate. This first
// version multiplies with plain float32 FMAs on the CUDA cores (67 TFLOP/s
// peak), so it cannot come near that bound; mma.sync / wgmma tiles fed by
// TMA are the later work that would.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per shared-memory tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLDP = kBK + 1;   // padded row of the probability tile

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

template <int HD>
constexpr int smem_floats() {
  return kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * kLDP;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int T_, int H, int KV, int causal, int window,
                       float sqrt_hd) {
  constexpr int LD = HD + 1;
  constexpr int NJ = HD / 16;
  extern __shared__ float smem[];
  float* qs = smem;                // kBQ x LD
  float* ks = qs + kBQ * LD;       // kBK x LD
  float* vs = ks + kBK * LD;       // kBK x HD
  float* ps = vs + kBK * HD;       // kBQ x kLDP

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int s = q0 + r;
    qs[r * LD + d] =
        s < S ? to_f32(q[((int64_t(b) * S + s) * H + h) * HD + d]) : 0.0f;
  }

  float acc[4][NJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  // keys this query tile can see: [kv_begin, kv_end)
  const int kv_end = causal ? min(T_, q0 + kBQ) : T_;
  const int kv_begin =
      window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      const int t = k0 + c;
      float kx = 0.0f, vx = 0.0f;
      if (t < T_) {
        const int64_t off = ((int64_t(b) * T_ + t) * KV + kvh) * HD + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[c * LD + d] = kx;
      vs[c * HD + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool ok = col < T_;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && row - col < window;
        s[i][j] = ok ? s[i][j] / sqrt_hd : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // a row with no visible key yet keeps m = -inf, l = 0, acc = 0
      const float alpha = m_new == -INFINITY ? 1.0f : expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = m_new == -INFINITY ? 0.0f : expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kLDP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();   // the probability tile is complete

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kLDP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vx = vs[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vx, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((int64_t(b) * S + s) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_, int H, int KV, int causal, int window,
           cudaStream_t stream) {
  const int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, T_, H, KV, causal,
      window, sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* out,
                int B, int S, int T_, int H, int KV, int hd, int causal,
                int window, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, S, T_, H, KV, causal, window,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, T_, H, KV, causal, window,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, T_, H, KV, causal, window,
                            stream);
    default:
      return -1;
  }
}

}  // namespace

// C interface, bound with ctypes (kernels/flash_attention/kernel.py).
// q (B, S, H, hd), k and v (B, T, KV, hd), out (B, S, H, hd), all
// contiguous and of one type: dtype 0 = float32, 1 = bfloat16. hd is 32,
// 64 or 128 and H a multiple of KV. Launches on `stream`; returns
// cudaGetLastError() (0 = launched) or -1 for a shape or type it does not
// take.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int dtype,
                                   int B, int S, int T, int H, int KV,
                                   int hd, int causal, int window,
                                   void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KV <= 0 || H % KV != 0) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, out, B, S, T, H, KV, hd, causal,
                              window, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, out, B, S, T, H, KV, hd,
                                      causal, window, st);
  return -1;
}
