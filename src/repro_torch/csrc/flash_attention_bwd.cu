// Blockwise causal GQA flash attention, backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's flash kernel
// (kernels/flash_attention/kernel.py::flash_attention_bhsd) is forward
// only, and the reference trains by differentiating its jnp attention
// (models/layers.py::causal_attention). The port's layers send attention
// through the hand-written forward, so training needs this backward.
//
// Inputs in the model's layout: q, dO (B, S, H, hd); k, v (B, T, KV, hd),
// T == S; lse (B, H, S) float32, the forward's per-row log-sum-exp of the
// scaled scores (flash_attention.cu writes it). Outputs dQ (B, S, H, hd),
// dK and dV (B, T, KV, hd) in the inputs' type, float32 inside:
//   P_rc  = exp(s_rc - lse_r) over the visible keys (0 elsewhere),
//           s_rc = (q_r . k_c) / sqrt(hd)
//   dP_rc = dO_r . v_c
//   D_r   = sum_c P_rc dP_rc
//   dS_rc = P_rc (dP_rc - D_r)
//   dQ_r  = sum_c dS_rc k_c / sqrt(hd)
//   dK_c  = sum_{r, heads of c's group} dS_rc q_r / sqrt(hd)
//   dV_c  = sum_{r, heads of c's group} P_rc dO_r
// A key c is visible to row r when c < T and, when causal, c <= r and,
// when window > 0, r - c < window: the forward's mask. The scores are
// summed in the float32 forward's order and divided by sqrt(hd) as it
// divides them, so in float32 they are the forward's bits and s - lse <= 0;
// the exponent is clamped at 0 all the same (P <= 1), so where the
// bfloat16 forward's tensor-core sums round otherwise, or the scores are
// so large that lse rounds to the row's maximum, P cannot overflow.
//
// Bound: operations. The function needs 2.5x the forward's causal FLOPs
// (QK^T, dO V^T, dS^T Q, P^T dO, dS K against QK^T and PV); at yi-9b's
// prefill shape (B=1, S=4096, H=32, KV=4, hd=128) that is 343.6 GFLOP a
// layer, 0.347 ms at the H100's 989 TFLOP/s bf16 tensor-core rate.
//
// D is the sum of the very P dP products that dS uses, as autograd's
// softmax backward forms it, and not FlashAttention's rowsum(dO * O):
// the two are equal in exact arithmetic, but in a row whose softmax has
// saturated to one-hot (scores far above 1e4, which the reference's LM
// reaches within a few steps at learning rate 0.3) autograd's dS is
// exactly 0, while rowsum(dO * O) rounds apart from dP and leaves a
// residue that the huge K then multiplies into dQ and dK.
//
// Design: the first one, simple and deterministic, on CUDA cores for both
// types (bfloat16 is widened to float32 on load). Two kernels, with no
// atomics, so a rerun gives the same bits:
// 1. dq: one block of 256 threads a (b, h, 64-row query tile), walking the
//    key tiles the forward walks twice: first for D (written out for the
//    dkdv kernel), then recomputing P and dP for dS and dQ, which
//    accumulates in registers.
// 2. dkdv: one block of 256 threads a (b, kv head, 64-key tile). It keeps
//    K and V of its tile in shared memory and walks every 64-row query
//    tile of every head of the kv head's group that can see the tile (the
//    causal triangle and the window bound the walk), recomputing P from
//    lse; dK and dV accumulate in registers across the group's heads, so
//    the G heads that share a K/V tile need no reduction across blocks.
// The thread layout is the forward's float32 route: thread (ty, tx) of
// 16 x 16 owns rows ty + 16 i (i < 4) and score columns tx + 16 j (j < 4)
// of a 64 x 64 tile, and output columns tx + 16 j (j < hd / 16) of its
// rows. Shared-memory rows of hd are padded to hd + 1 floats, so 16 lanes
// reading 16 rows hit 16 banks. The P / dS tile is one 64 x 65 buffer,
// rewritten between the dV and dK products. At hd 160 a block holds
// 182 KB of shared memory. Performance is later work: this design runs on
// the CUDA cores' 67 TFLOP/s float32 FMAs and computes QK^T and dO V^T
// three times (twice in dq, once in dkdv): 3.5x the forward's products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;         // query rows per tile
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLDP = kBK + 1;   // padded row of the P / dS tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool visible(int row, int col, int S, int T_,
                                        int causal, int window) {
  bool ok = row < S && col < T_;
  if (causal) ok = ok && col <= row;
  if (window > 0) ok = ok && row - col < window;
  return ok;
}

template <int HD>
constexpr int smem_floats() {
  return 4 * 64 * (HD + 1) + kBQ * kLDP + 2 * kBQ;
}

// Rows [r0, r0 + 64) of one head of a (B, seq, heads, HD) tensor into a
// 64 x (HD + 1) shared tile, zero past `seq`.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int r0, int seq, int heads,
                                          int head) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < 64 * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int s = r0 + r;
    dst[r * LD + d] =
        s < seq ? to_f32(src[((int64_t(b) * seq + s) * heads + head) * HD + d])
                : 0.0f;
  }
}

// acc[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over two padded
// 64 x HD tiles.
template <int HD>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         float (&acc)[4][4]) {
  constexpr int LD = HD + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int T_, int H, int KV,
                      int causal, int window, float sqrt_hd, float scale) {
  constexpr int LD = HD + 1;
  constexpr int NJ = HD / 16;
  extern __shared__ float smem[];
  float* ks = smem;                // kBK x LD
  float* vs = ks + kBK * LD;       // kBK x LD
  float* qs = vs + kBK * LD;       // kBQ x LD
  float* dos = qs + kBQ * LD;      // kBQ x LD
  float* ps = dos + kBQ * LD;      // kBQ x kLDP: P, then dS
  float* lse_s = ps + kBQ * kLDP;  // kBQ
  float* del_s = lse_s + kBQ;      // kBQ

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;

  load_tile<T, HD>(ks, k, b, k0, T_, KV, kvh);
  load_tile<T, HD>(vs, v, b, k0, T_, KV, kvh);

  float acc_dk[4][NJ], acc_dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.0f;

  // query rows that see a key of this tile: [q_begin, q_end)
  const int q_begin = causal ? k0 / kBQ * kBQ : 0;
  const int q_end = window > 0 ? min(S, k0 + kBK - 1 + window) : S;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int q0 = q_begin; q0 < q_end; q0 += kBQ) {
      __syncthreads();   // the previous tile's readers are done
      load_tile<T, HD>(qs, q, b, q0, S, H, h);
      load_tile<T, HD>(dos, dout, b, q0, S, H, h);
      if (threadIdx.x < kBQ) {
        const int s = q0 + threadIdx.x;
        const int64_t off = (int64_t(b) * H + h) * S + s;
        lse_s[threadIdx.x] = s < S ? lse[off] : 0.0f;
        del_s[threadIdx.x] = s < S ? delta[off] : 0.0f;
      }
      __syncthreads();

      // P and dS, rows (queries) ty + 16 i, columns (keys) tx + 16 j
      float p[4][4], ds[4][4];
      tile_dot<HD>(qs, ks, p);
      tile_dot<HD>(dos, vs, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float pv =
              visible(q0 + r, k0 + c, S, T_, causal, window)
                  ? expf(fminf(p[i][j] / sqrt_hd - lse_s[r], 0.0f))
                  : 0.0f;
          ds[i][j] = pv * (ds[i][j] - del_s[r]);
          ps[r * kLDP + c] = pv;
        }
      }
      __syncthreads();   // P is complete

      // dV (keys ty + 16 i, columns tx + 16 j) += P^T dO
#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        float pr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pr[i] = ps[r * kLDP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float x = dos[r * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc_dv[i][j] = fmaf(pr[i], x, acc_dv[i][j]);
        }
      }
      __syncthreads();   // P's readers are done: the tile takes dS
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ps[(ty + 16 * i) * kLDP + tx + 16 * j] = ds[i][j];
      __syncthreads();

      // dK += dS^T Q (scaled at the end)
#pragma unroll 4
      for (int r = 0; r < kBQ; ++r) {
        float dr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dr[i] = ps[r * kLDP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float x = qs[r * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc_dk[i][j] = fmaf(dr[i], x, acc_dk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= T_) continue;
    const int64_t off = ((int64_t(b) * T_ + t) * KV + kvh) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[off + tx + 16 * j] = from_f32<T>(acc_dk[i][j] * scale);
      dv[off + tx + 16 * j] = from_f32<T>(acc_dv[i][j]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq,
                    int S, int T_, int H, int KV, int causal, int window,
                    float sqrt_hd, float scale) {
  constexpr int LD = HD + 1;
  constexpr int NJ = HD / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kBK * LD;
  float* qs = vs + kBK * LD;
  float* dos = qs + kBQ * LD;
  float* ps = dos + kBQ * LD;      // dS
  float* lse_s = ps + kBQ * kLDP;
  float* del_s = lse_s + kBQ;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  load_tile<T, HD>(qs, q, b, q0, S, H, h);
  load_tile<T, HD>(dos, dout, b, q0, S, H, h);
  if (threadIdx.x < kBQ) {
    const int s = q0 + threadIdx.x;
    lse_s[threadIdx.x] = s < S ? lse[(int64_t(b) * H + h) * S + s] : 0.0f;
  }

  // keys this query tile can see: [kv_begin, kv_end), as in the forward
  const int kv_end = causal ? min(T_, q0 + kBQ) : T_;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;

  // pass 1: D_r = sum_c P_rc dP_rc, rows ty + 16 i; a thread sums its
  // columns in order, then its half-warp's 16 partial sums in a fixed tree
  float dsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, HD>(ks, k, b, k0, T_, KV, kvh);
    load_tile<T, HD>(vs, v, b, k0, T_, KV, kvh);
    __syncthreads();
    float p[4][4], dp[4][4];
    tile_dot<HD>(qs, ks, p);
    tile_dot<HD>(dos, vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv =
            visible(q0 + r, k0 + tx + 16 * j, S, T_, causal, window)
                ? expf(fminf(p[i][j] / sqrt_hd - lse_s[r], 0.0f))
                : 0.0f;
        dsum[i] = fmaf(pv, dp[i][j], dsum[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], o);
    const int r = ty + 16 * i;
    if (tx == 0) {
      del_s[r] = dsum[i];
      if (q0 + r < S) delta[(int64_t(b) * H + h) * S + q0 + r] = dsum[i];
    }
  }

  // pass 2: dS and dQ
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    load_tile<T, HD>(ks, k, b, k0, T_, KV, kvh);
    load_tile<T, HD>(vs, v, b, k0, T_, KV, kvh);
    __syncthreads();

    float p[4][4], ds[4][4];
    tile_dot<HD>(qs, ks, p);
    tile_dot<HD>(dos, vs, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float pv =
            visible(q0 + r, k0 + c, S, T_, causal, window)
                ? expf(fminf(p[i][j] / sqrt_hd - lse_s[r], 0.0f))
                : 0.0f;
        ps[r * kLDP + c] = pv * (ds[i][j] - del_s[r]);
      }
    }
    __syncthreads();   // dS is complete

    // dQ (rows ty + 16 i, columns tx + 16 j) += dS K
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = ps[(ty + 16 * i) * kLDP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float x = ks[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dr[i], x, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    T* dst = dq + ((int64_t(b) * S + s) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dst[tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv,
           int B, int S, int T_, int H, int KV, int causal, int window,
           cudaStream_t stream) {
  const int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float sqrt_hd = sqrtf(static_cast<float>(HD));
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);

  // dq first: it writes D, which dkdv reads
  const dim3 grid_q((S + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq_kernel<T, HD><<<grid_q, kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), S, T_, H, KV, causal,
      window, sqrt_hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_kv((T_ + kBK - 1) / kBK, KV, B);
  flash_bwd_dkdv_kernel<T, HD><<<grid_kv, kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, T_, H, KV, causal, window, sqrt_hd, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, float* delta, void* dq,
                 void* dk, void* dv, int B, int S, int T_, int H, int KV,
                 int causal, int window, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, HD>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, T_,
                             H, KV, causal, window, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, HD>(q, k, v, dout, lse, delta, dq, dk, dv,
                                     B, S, T_, H, KV, causal, window, stream);
  return -1;
}

}  // namespace

// C interface, bound with ctypes (kernels/flash_attention/kernel.py).
// q, dout, dq (B, S, H, hd); k, v, dk, dv (B, T, KV, hd), T == S; all
// contiguous and of one type: dtype 0 = float32, 1 = bfloat16. lse and
// delta are float32 (B, H, S): lse the forward's, delta scratch that the
// call writes (D). hd is 32, 64, 128 or 160 and H a multiple of KV.
// Launches two kernels on `stream`; returns cudaGetLastError() after each
// (0 = launched) or -1 for a shape or type it does not take.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int dtype, int B,
                                   int S, int T, int H, int KV, int hd,
                                   int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || T != S || KV <= 0 || H % KV != 0) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  switch (hd) {
    case 32:
      return launch_dtype<32>(dtype, q, k, v, dout, l, d, dq, dk, dv, B, S,
                              T, H, KV, causal, window, st);
    case 64:
      return launch_dtype<64>(dtype, q, k, v, dout, l, d, dq, dk, dv, B, S,
                              T, H, KV, causal, window, st);
    case 128:
      return launch_dtype<128>(dtype, q, k, v, dout, l, d, dq, dk, dv, B, S,
                              T, H, KV, causal, window, st);
    case 160:
      return launch_dtype<160>(dtype, q, k, v, dout, l, d, dq, dk, dv, B, S,
                              T, H, KV, causal, window, st);
    default:
      return -1;
  }
}
