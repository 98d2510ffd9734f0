// Blockwise causal GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/flash_attention/kernel.py::flash_attention_bhsd (body
// _flash_kernel) together with the transposes of its wrapper ops.py: both
// routes below read q (B, S, H, hd) and k, v (B, T, KV, hd) in the model's
// own layout and write out (B, S, H, hd), so no transpose is materialized.
//
// For each query row r and head h (kv head h / (H / KV)):
//   s_c = (q_r . k_c) / sqrt(hd)   over the keys c with c < T and,
//         when causal, c <= r and, when window > 0, r - c < window
//   out_r = sum_c softmax(s)_c v_c
// with the scores, the online-softmax state and the probabilities in
// float32 whatever the input type; out is divided by max(l, 1e-30) and
// rounded to the input type once at the end.
//
// Bound: operations. A causal self-attention over S tokens needs about
// 4 B H hd S (S + 1) / 2 flops (QK^T and PV, upper triangle skipped); for
// yi-9b's prefill at B=1, S=4096, H=32, hd=128 that is 137.5 GFLOP a
// layer, 0.139 ms at the H100's 989 TFLOP/s bf16 tensor-core rate; for
// stablelm-12b's at H=32, hd=160, 171.8 GFLOP, 0.174 ms.
//
// Two routes, chosen by dtype in flash_attention_fwd (not a fallback: each
// dtype has exactly one):
//
// bfloat16: tensor cores (namespace tc). One block of 384 threads owns one
// (b, h, 128-row query tile): warpgroup 0 is the producer, whose one
// thread issues TMA loads, and warpgroups 1 and 2 each own 64 query rows.
// setmaxnreg moves registers from the producer (24) to the consumers
// (240). Q is loaded once; K and V tiles of 128 keys go through a 2-stage
// ring, each stage with a "full" mbarrier per operand (completed by the
// TMA transaction count) and an "empty" one (completed by the 256 consumer
// threads), so the next tile's loads are in flight while this one is
// multiplied. The tensor maps are 4-D over (hd, heads, seq, batch), built
// on the host for each launch (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so no -lcuda); a ragged S or T tile is
// zero-filled inside its own sequence. Boxes are 64 bf16 wide (128 B
// swizzle) where hd is a multiple of 64, so hd = 128 takes two per tile,
// and 32 wide (64 B swizzle) otherwise: hd = 32 takes one, hd = 160 five
// (Q 40 KB, two stages of K and V 160 KB: 201 KB of shared memory).
// S = Q K^T is a wgmma m64n128k16 with both operands in shared memory,
// K-major. The online softmax runs on the accumulator fragment (each row
// lives in one quad of threads); only the causal diagonal tile, the
// window's edge tile and the ragged-T tile are masked per element. P V is
// a register-A wgmma with V MN-major (transpose bit) from shared memory.
// P is not rounded to bf16 for it: P = P_hi + P_lo with P_hi = bf16(P) and
// P_lo = bf16(P - P_hi), two wgmmas into one float32 accumulator, leaving
// a residual near 2^-17 of P, far below the output's one bf16 rounding.
// That costs 1.5x the tensor-core work the function needs; the bound
// above counts only the function's. The grid is (H, query tiles, B):
// heads that share a kv head are adjacent, so their K/V reads meet in L2,
// and the query tiles run heaviest (longest causal row) first.
//
// Both routes also write lse (B, H, S), float32, when given a pointer for
// it: each row's log-sum-exp of its scaled scores, m + log(l) in natural
// units, which the backward (flash_attention_bwd.cu) reads to rebuild P.
// Without the pointer (serving) nothing else changes.
//
// float32: CUDA cores (namespace simt, on simt_tile.cuh). One block of 128
// threads owns one (b, h, 32-row query tile); the grid runs the query
// tiles heaviest (longest causal row) first, so 320 blocks at a
// fedsr-lm-100m lane (B=4, S=256, H=10, hd=64) spread over the 132 SMs.
// Key and value tiles of 32 rows go through a two-stage ring of 16-byte
// cp.async copies, so the next tile's loads are in flight while this one
// is multiplied; rows are padded to hd + 4 floats (42.5 KB a block at
// hd 64, so four blocks share an SM). The scores are simt_tile.cuh's
// chain (each one fmaf chain in d order, then divided by sqrt(hd)): the
// backward rebuilds these bits. The online-softmax state lives in
// registers, a row's statistics reduce over its eight lanes with
// shuffles; P goes through the stage's K tile into the register-blocked
// P V product (float4 reads, 2 rows x hd / 8 columns a thread). Tiles
// wholly above the causal diagonal or before the window are never loaded.
// Rows past S are masked here, not padded by the caller. Bound at the
// lane: 336.9 MFLOP of causal products at the 67 TFLOP/s float32 rate,
// 0.0050 ms; a float32 product on tensor cores would need a 3xTF32 split.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

// tc's geometry (kBQ, kBK, kStages, kThreads, Tile), its TMA, mbarrier and
// wgmma helpers and encode_map
#include "hopper_tc.cuh"
// simt's tile geometry, cp.async loader, score chain and product
#include "simt_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32 route: CUDA-core FMAs

namespace simt {

// Shared memory of one block: Q (32 rows) and two ring stages of K and V
// (32 keys each); P takes the stage's K tile once its scores are formed.
template <int HD>
constexpr int fwd_smem_floats() {
  return 5 * tile_floats<HD>();
}

template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 4 : 1)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, int S, int T_, int H, int KV,
                       int causal, int window, float sqrt_hd) {
  constexpr int TILE = tile_floats<HD>();
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* qs = smem;                 // Q; stage st: K at ring + 2 st TILE
  float* ring = qs + TILE;          // and V one TILE after it

  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // heaviest first
  const int kvh = h / (H / KV);
  // keys this query tile can see: [kv_begin, kv_end)
  const int kv_end = causal ? min(T_, q0 + kRows) : T_;
  const int kv_begin =
      window > 0 ? max(0, q0 - window + 1) / kRows * kRows : 0;
  const int n_tiles = (kv_end - kv_begin + kRows - 1) / kRows;

  load_rows<HD>(qs, q, b, q0, S, H, h);
  load_rows<HD>(ring, k, b, kv_begin, T_, KV, kvh);
  load_rows<HD>(ring + TILE, v, b, kv_begin, T_, KV, kvh);
  cp_async_commit();

  float acc[2][HD / 8];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) acc[i][j] = 0.0f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_begin + it * kRows;
    float* ks = ring + 2 * (it % 2) * TILE;
    float* vs = ks + TILE;
    // the next tile's K and V into the other stage, freed at the end of
    // the previous iteration, while this one is multiplied
    if (it + 1 < n_tiles) {
      float* kn = ring + 2 * ((it + 1) % 2) * TILE;
      load_rows<HD>(kn, k, b, k0 + kRows, T_, KV, kvh);
      load_rows<HD>(kn + TILE, v, b, k0 + kRows, T_, KV, kvh);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // this tile's copies, every thread's, have landed

    float s[2][4];
    chain_tile<HD>(s, qs, ks);
    float p[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 8 * j;
        bool ok = col < T_;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && row - col < window;
        s[i][j] = ok ? s[i][j] / sqrt_hd : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // a row with no visible key yet keeps m = -inf, l = 0, acc = 0
      const float alpha = m_new == -INFINITY ? 1.0f : expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = m_new == -INFINITY ? 0.0f : expf(s[i][j] - m_new);
        rs += p[i][j];
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();   // every thread's scores are formed: K is free
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ks[(ty + 16 * i) * kLDP + tx + 8 * j] = p[i][j];
    __syncthreads();   // the probability tile is complete
    product_tile<HD>(acc, ks, vs);
    __syncthreads();   // the stage's readers are done: it takes tile it + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    // m and l are the row's over its eight lanes
    if (lse != nullptr && tx == 0)
      lse[(int64_t(b) * H + h) * S + row] = m[i] + logf(l[i]);
    float* o = out + ((int64_t(b) * S + row) * H + h) * HD;
#pragma unroll
    for (int g = 0; g < HD / 32; ++g)
      *reinterpret_cast<float4*>(o + 4 * (tx + 8 * g)) = make_float4(
          acc[i][4 * g] / denom, acc[i][4 * g + 1] / denom,
          acc[i][4 * g + 2] / denom, acc[i][4 * g + 3] / denom);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int S, int T_, int H, int KV, int causal,
           int window, cudaStream_t stream) {
  const int smem = fwd_smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kRows - 1) / kRows);
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, T_, H,
      KV, causal, window, sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16 route: wgmma fed by TMA

namespace tc {

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int S, int T_, int H, int KV,
                       int causal, int window, float scale_log2) {
  using L = Tile<HD>;
  constexpr int NS = kBK / 2;        // score registers a thread
  constexpr int KS = kBK / 16;       // 16-key steps of a tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + L::kQBytes;             // stage st: + st * kKVBytes
  const uint32_t v_s = k_s + kStages * L::kKVBytes;
  const uint32_t q_full = v_s + kStages * L::kKVBytes;
  const uint32_t k_full = q_full + 8;                 // + 8 st
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  // keys this query tile can see: [kv_begin, kv_end)
  const int kv_end = causal ? min(T_, q0 + kBQ) : T_;
  const int kv_begin =
      window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int n_tiles = (kv_end - kv_begin + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring's loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load(q_s + c * L::kQBox, &tm_q, q_full, c * L::kBoxCols, h, q0,
                 b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t parity = (i / kStages) & 1;
        const int k0 = kv_begin + i * kBK;
        mbar_wait(empty + 8 * st, parity ^ 1);   // round 0 passes at once
        mbar_expect_tx(k_full + 8 * st, L::kKVBytes);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load(k_s + st * L::kKVBytes + c * L::kKBox, &tm_k,
                   k_full + 8 * st, c * L::kBoxCols, kvh, k0, b);
        mbar_expect_tx(v_full + 8 * st, L::kKVBytes);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load(v_s + st * L::kKVBytes + c * L::kKBox, &tm_v,
                   v_full + 8 * st, c * L::kBoxCols, kvh, k0, b);
      }
    }
  } else {
    // consumers: warpgroup wg - 1 owns query rows q0 + 64 (wg - 1) + [0, 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lt = threadIdx.x % 128;
    const int r_lo = q0 + 64 * (wg - 1);
    const int row0 = r_lo + 16 * (lt / 32) + (lt % 32) / 4;  // and row0 + 8
    const int col0 = 2 * (lt % 4);
    const uint32_t q_wg = q_s + 64 * (wg - 1) * L::kRowBytes;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
    // row max (in units of scale_log2 * score) and this thread's share of
    // the row sum, for rows row0 and row0 + 8
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    mbar_wait(q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int k0 = kv_begin + i * kBK;
      const uint32_t k_t = k_s + st * L::kKVBytes;
      const uint32_t v_t = v_s + st * L::kKVBytes;

      float s[NS];
      mbar_wait(k_full + 8 * st, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk * 16) / L::kBoxCols * L::kQBox +
                             (kk * 16) % L::kBoxCols * 2;
        const uint32_t koff = (kk * 16) / L::kBoxCols * L::kKBox +
                              (kk * 16) % L::kBoxCols * 2;
        wgmma_m64n128k16_ss(s, desc_k_major<HD>(q_wg + off),
                            desc_k_major<HD>(k_t + koff), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // per-element mask only where some (row, col) of this warpgroup's
      // 64 x 128 block is invisible: the diagonal, the window's edge, the
      // ragged end of T
      const bool edge = k0 + kBK > T_ || (causal && k0 + kBK - 1 > r_lo) ||
                        (window > 0 && r_lo + 63 - k0 >= window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row0 + 8 * (e >> 1);
            const int col = k0 + 8 * j + col0 + (e & 1);
            bool ok = col < T_;
            if (causal) ok = ok && col <= row;
            if (window > 0) ok = ok && row - col < window;
            if (!ok) s[4 * j + e] = -INFINITY;
          }
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx * scale_log2);
        // a row with no visible key yet keeps m = -inf, l = 0, o = 0:
        // alpha 1, every p 0
        const float base = m_new == -INFINITY ? 0.0f : m_new;
        const float alpha = m_new == -INFINITY ? 1.0f : exp2f(m[r] - base);
        m[r] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * r + e];
            x = exp2f(fmaf(x, scale_log2, -base));
            sum += x;
          }
        l[r] = alpha * l[r] + sum;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[4 * j + 2 * r] *= alpha;
          o[4 * j + 2 * r + 1] *= alpha;
        }
      }

      // P = P_hi + P_lo in bf16, laid out as wgmma's A fragment: the
      // score fragment's 16-key step kk is the A fragment of step kk
      uint32_t p_hi[KS][4], p_lo[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x = s[8 * kk + 2 * c], y = s[8 * kk + 2 * c + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
          const float2 hf = __bfloat1622float2(hi);
          p_hi[kk][c] = bf16x2_bits(hi);
          p_lo[kk][c] = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
        }

      mbar_wait(v_full + 8 * st, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint64_t db = desc_mn_major<HD>(v_t + kk * 16 * L::kRowBytes);
        wgmma_pv<HD>(o, p_hi[kk], db);
        wgmma_pv<HD>(o, p_lo[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(p_hi);
      fence_regs(p_lo);
      mbar_arrive(empty + 8 * st);   // this thread is done with the stage
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      // m is in units of log2: the natural log-sum-exp is m ln 2 + log(l)
      if (lse != nullptr && col0 == 0)
        lse[(int64_t(b) * H + h) * S + row] =
            m[r] * 0.6931471805599453f + logf(l[r]);
      __nv_bfloat16* dst = out + ((int64_t(b) * S + row) * H + h) * HD + col0;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / denom,
                                  o[4 * j + 2 * r + 1] / denom);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int S, int T_, int H, int KV, int causal,
           int window, cudaStream_t stream) {
  using L = Tile<HD>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_map(&tm_q, q, B, S, H, HD, L::kBoxCols, kBQ) ||
      !encode_map(&tm_k, k, B, T_, KV, HD, L::kBoxCols, kBK) ||
      !encode_map(&tm_v, v, B, T_, KV, HD, L::kBoxCols, kBK))
    return -2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, (S + kBQ - 1) / kBQ, B);
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(HD)));
  flash_attention_kernel<HD><<<grid, kThreads, L::kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), lse, S, T_, H, KV,
      causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// The route is chosen by dtype: float32 on CUDA cores, bfloat16 on tensor
// cores. Each dtype has exactly one route; neither falls back to the other.
template <int HD>
int launch_route(const void* q, const void* k, const void* v, void* out,
                 float* lse, int dtype, int B, int S, int T_, int H, int KV,
                 int causal, int window, cudaStream_t stream) {
  if (dtype == 0)
    return simt::launch<HD>(q, k, v, out, lse, B, S, T_, H, KV, causal,
                            window, stream);
  if (dtype == 1)
    return tc::launch<HD>(q, k, v, out, lse, B, S, T_, H, KV, causal, window,
                          stream);
  return -1;
}

}  // namespace

// C interface, bound with ctypes (kernels/flash_attention/kernel.py).
// q (B, S, H, hd), k and v (B, T, KV, hd), out (B, S, H, hd), all
// contiguous, 16-byte aligned (TMA and cp.async read them) and of one
// type: dtype 0 = float32 (the CUDA-core route), 1 = bfloat16 (the
// tensor-core route); lse (B, H, S) float32, or null to skip it. hd is 32,
// 64, 128 or 160 and H a multiple of KV.
// Launches on `stream`; returns cudaGetLastError() (0 = launched), -1 for
// a shape or type it does not take, or -2 when the TMA tensor maps cannot
// be encoded.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int dtype, int B, int S, int T, int H,
                                   int KV, int hd, int causal, int window,
                                   void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KV <= 0 || H % KV != 0) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 32:
      return launch_route<32>(q, k, v, out, l, dtype, B, S, T, H, KV, causal,
                              window, st);
    case 64:
      return launch_route<64>(q, k, v, out, l, dtype, B, S, T, H, KV, causal,
                              window, st);
    case 128:
      return launch_route<128>(q, k, v, out, l, dtype, B, S, T, H, KV,
                               causal, window, st);
    case 160:
      return launch_route<160>(q, k, v, out, l, dtype, B, S, T, H, KV,
                               causal, window, st);
    default:
      return -1;
  }
}
