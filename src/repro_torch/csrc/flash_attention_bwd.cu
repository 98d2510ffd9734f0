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
// when window > 0, r - c < window: the forward's mask. The exponent is
// clamped at 0 (P <= 1), so where the scores round otherwise than the
// forward's, or are so large that lse rounds to the row's maximum, P
// cannot overflow.
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
// Two routes, chosen by dtype (not a fallback: each dtype has exactly one;
// no atomics in either, so a rerun gives the same bits):
//
// float32: CUDA cores (namespace simt, on simt_tile.cuh, the forward's
// tiles). Its scores are simt_tile.cuh's chain, the float32 forward's, and
// divided by sqrt(hd) as the forward divides them, so they are the
// forward's bits, s - lse <= 0, and a saturated row's D cancels its dP
// exactly: every kernel forms dP with the same chain. Blocks of 128
// threads; 32-row tiles, rows padded to hd + 4 floats; the streamed tiles
// go through a two-stage ring of 16-byte cp.async copies, so the next
// tile's loads are in flight while this one is multiplied; S, dP and the
// dQ, dK and dV products are register-blocked float32 FMAs with float4
// reads (simt_tile.cuh). Two launches:
// 1. delta: one block a (b, h, 32-row query tile), heaviest tiles first,
//    with Q and dO in shared memory, walks the key tiles the forward walks
//    and writes D (51.0 KB a block at hd 64).
// 2. grad: the dkdv blocks, then the dq blocks, in one launch, so that the
//    two kinds fill the SMs together: at a fedsr-lm-100m lane (B=4, S=256,
//    H=KV=10, hd=64) 640 blocks, three to an SM, where either kind alone
//    has 320 for 132 SMs and the heaviest blocks' walks set the time.
//    A dkdv block owns a (b, kv head, 32-key tile), key tile 0 (the most
//    rows) first. It keeps K and V in shared memory and streams every
//    32-row query tile of every head of the kv head's group that can see
//    the tile (the causal triangle and the window bound the walk) through
//    the ring; lse and D of a query tile are read into registers (8 floats
//    a thread), so the block stays at 55.5 KB at hd 64. P^T, then dS^T,
//    go through one tile into dV += P^T dO and dK += dS^T Q; dK and dV
//    accumulate in registers across the group's heads. A dq block owns a
//    (b, h, 32-row query tile), heaviest first: it walks its key tiles
//    again, forms dS = P (dP - D), which takes the stage's V tile, and
//    accumulates dQ += dS K in registers.
// It computes QK^T and dO V^T three times: 9 product passes against the
// bound's 5.
//
// bfloat16: tensor cores (namespace tc), on the forward's skeleton
// (hopper_tc.cuh): blocks of 384 threads, warpgroup 0 the producer whose
// one thread issues TMA loads (setmaxnreg 24), warpgroups 1 and 2 the
// consumers (240) with 64 M-rows each; operands in shared memory in the
// forward's swizzled boxes, rings of stages with a "full" mbarrier (the
// TMA transaction count) and an "empty" one (the 256 consumer threads).
// Three kernels:
// A. dq: one block a (b, h, 128-row query tile), grid ordered heaviest
//    first as the forward's. Q and dO are loaded once; K and V tiles of BK
//    keys (128; 64 at hd 160, where two stages of 128-key K and V beside Q
//    and dO would take 240 KB) go through a 2-stage ring, over the
//    forward's key range, twice. S = Q K^T is the forward's wgmma
//    sequence (m64nBKk16, both operands K-major, kk in hd order), and
//    dP = dO V^T the same form. Walk 1 sums D_r = sum P dP, with
//    P = exp2(min(S log2(e) / sqrt(hd) - lse log2(e), 0)), masked per
//    element only on the edge tiles, in a fixed order over the quad, and
//    writes D and lse log2(e) into rows padded to a multiple of 128.
//    Walk 2 forms dS = P (dP - D) and accumulates dQ += dS K, a
//    register-A wgmma with K MN-major (the forward's P V). dQ is scaled
//    and rounded once at the end.
// B. dkdv: one block a (b, h, 128-key tile), keys the M dimension: 64 a
//    consumer, whose K and V are loaded once. Query tiles of BQ rows (64;
//    32 at hd 160, where dK and dV take 160 registers a thread) of Q and
//    dO, with their padded lse and D rows (a bulk copy), stream through a
//    3-stage ring over the rows that can see the key tile (the float32
//    route's causal and window bounds). S^T = K Q^T and dP^T = V dO^T are
//    shared-memory wgmmas; P^T and dS^T, taken from the accumulators (the
//    accumulator's 16-column step is a register A fragment), feed
//    dV += P^T dO and dK += dS^T Q as register-A wgmmas with dO and Q
//    MN-major, so P never goes through shared memory (FlashAttention-2/3's
//    layout). The grid runs the first key tiles (the most rows) first.
//    With G = H / KV = 1 it writes dK and dV; otherwise each query head
//    writes its own in float32 to a (2, B, T, H, hd) scratch, and
// C. sum_group_heads sums each kv head's G heads in head order and rounds
//    once (at yi-9b, about 268 MB of extra traffic, ~0.08 ms). A block per
//    query head keeps 1,024 blocks at yi-9b's shape where one per kv head
//    would give 128 on 132 SMs, the first doing 32x the last's work.
// Precision: P and dS are rounded once to bf16 as operands of the dQ, dK
// and dV products (D and dS are formed in float32). In bfloat16 the
// transposed products of B round S and dP otherwise than A does, so the
// D that B reads is not the sum of B's own P dP bits; neither route
// reproduces the bfloat16 forward's S bits (lse clamps P <= 1). The exact
// cancellation of a saturated row holds in float32, the training route
// that needs it. Work: S and dP twice in A and once in B, plus dQ, dV and
// dK: 9 product passes against the bound's 5 (1.8x).

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

// The D kernel and the dq blocks: Q and dO (32 rows) and two ring stages
// of K and V (32 keys); dS takes the stage's V tile once dP is formed.
template <int HD>
constexpr int dq_smem_floats() {
  return 6 * tile_floats<HD>();
}

// The dkdv blocks: K and V (32 keys), two ring stages of Q and dO (32
// rows) and one tile for P^T, then dS^T.
template <int HD>
constexpr int dkdv_smem_floats() {
  return 6 * tile_floats<HD>() + kRows * kLDP;
}

// P of one unscaled score given its row's lse: 0 where (row, col) is
// invisible, the exponent clamped at 0.
__device__ __forceinline__ float prob(float s, float sqrt_hd, float lse_r,
                                      bool ok) {
  return ok ? expf(fminf(s / sqrt_hd - lse_r, 0.0f)) : 0.0f;
}

// One walk of a (b, h, 32-row query tile) over the key tiles the forward
// walks. kDelta: D_r = sum_c P_rc dP_rc, written to delta. Otherwise, with
// D read from delta: dS = P (dP - D) and dQ += dS K, written to dq.
template <int HD, bool kDelta>
__device__ __forceinline__ void dq_walk(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta,
    float* __restrict__ dq, int S, int T_, int H, int KV, int causal,
    int window, float sqrt_hd, float scale, int pair, int q0) {
  constexpr int TILE = tile_floats<HD>();
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* qs = smem;
  float* dos = qs + TILE;
  float* ring = dos + TILE;   // stage st: K at ring + 2 st TILE, V after it

  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int h = pair % H;
  const int b = pair / H;
  const int kvh = h / (H / KV);
  // keys this query tile can see: [kv_begin, kv_end), as in the forward
  const int kv_end = causal ? min(T_, q0 + kRows) : T_;
  const int kv_begin =
      window > 0 ? max(0, q0 - window + 1) / kRows * kRows : 0;
  const int n_tiles = (kv_end - kv_begin + kRows - 1) / kRows;
  const int64_t bh = int64_t(b) * H + h;

  load_rows<HD>(qs, q, b, q0, S, H, h);
  load_rows<HD>(dos, dout, b, q0, S, H, h);
  load_rows<HD>(ring, k, b, kv_begin, T_, KV, kvh);
  load_rows<HD>(ring + TILE, v, b, kv_begin, T_, KV, kvh);
  cp_async_commit();

  // lse and D of rows ty and ty + 16 (0 past S, where Q and dO are zero)
  float lse_r[2], d_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < S ? lse[bh * S + row] : 0.0f;
    d_r[i] = !kDelta && row < S ? delta[bh * S + row] : 0.0f;
  }
  float acc[2][HD / 8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) acc[i][j] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_begin + it * kRows;
    float* ks = ring + 2 * (it % 2) * TILE;
    float* vs = ks + TILE;
    if (it + 1 < n_tiles) {
      float* kn = ring + 2 * ((it + 1) % 2) * TILE;
      load_rows<HD>(kn, k, b, k0 + kRows, T_, KV, kvh);
      load_rows<HD>(kn + TILE, v, b, k0 + kRows, T_, KV, kvh);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // this tile's copies, every thread's, have landed

    float s[2][4], dp[2][4];
    chain_tile<HD>(s, qs, ks);
    chain_tile<HD>(dp, dos, vs);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = prob(s[i][j], sqrt_hd, lse_r[i],
                             visible(q0 + ty + 16 * i, k0 + tx + 8 * j, S,
                                     T_, causal, window));
        // a thread sums its columns in order, tile after tile
        if (kDelta) d_r[i] = fmaf(p, dp[i][j], d_r[i]);
        s[i][j] = p * (dp[i][j] - d_r[i]);
      }
    if (!kDelta) {
      __syncthreads();   // every thread's dP is formed: V is free
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          vs[(ty + 16 * i) * kLDP + tx + 8 * j] = s[i][j];
      __syncthreads();   // dS is complete
      product_tile<HD>(acc, vs, ks);
    }
    __syncthreads();   // the stage's readers are done: it takes tile it + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + ty + 16 * i;
    if (kDelta) {
      // a row's eight partial sums in a fixed butterfly, which leaves the
      // same bits in all eight lanes
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        d_r[i] += __shfl_xor_sync(0xffffffffu, d_r[i], o);
      if (tx == 0 && row < S) delta[bh * S + row] = d_r[i];
    } else if (row < S) {
      store_row<HD>(dq + ((int64_t(b) * S + row) * H + h) * HD, acc[i],
                    scale);
    }
  }
}

// dK and dV of a (b, kv head, 32-key tile): every 32-row query tile of
// every head of the kv head's group that can see the tile streams through
// the ring; P^T, then dS^T, go through one tile.
template <int HD>
__device__ __forceinline__ void dkdv_block(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int S, int T_, int H,
    int KV, int causal, int window, float sqrt_hd, float scale, int pair,
    int k0) {
  constexpr int TILE = tile_floats<HD>();
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* ks = smem;
  float* vs = ks + TILE;
  float* ring = vs + TILE;        // stage st: Q at ring + 2 st TILE, dO after
  float* ps = ring + 4 * TILE;    // P^T, then dS^T: kRows x kLDP

  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int kvh = pair % KV;
  const int b = pair / KV;
  const int G = H / KV;
  // query rows that see a key of this tile: [q_begin, q_end), for each of
  // the G heads of the kv head's group
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + kRows - 1 + window) : S;
  const int nq = (q_end - q_begin + kRows - 1) / kRows;
  const int n_tiles = G * nq;

  load_rows<HD>(ks, k, b, k0, T_, KV, kvh);
  load_rows<HD>(vs, v, b, k0, T_, KV, kvh);
  load_rows<HD>(ring, q, b, q_begin, S, H, kvh * G);
  load_rows<HD>(ring + TILE, dout, b, q_begin, S, H, kvh * G);
  cp_async_commit();

  float acc_dk[2][HD / 8], acc_dv[2][HD / 8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int h = kvh * G + it / nq;
    const int q0 = q_begin + it % nq * kRows;
    float* qs = ring + 2 * (it % 2) * TILE;
    float* dos = qs + TILE;
    // this tile's lse and D for query columns tx + 8 j, read here so that
    // the products below hide their latency
    float lq[4], dd[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = q0 + tx + 8 * j;
      const int64_t off = (int64_t(b) * H + h) * S + row;
      lq[j] = row < S ? lse[off] : 0.0f;
      dd[j] = row < S ? delta[off] : 0.0f;
    }
    if (it + 1 < n_tiles) {
      const int hn = kvh * G + (it + 1) / nq;
      const int qn = q_begin + (it + 1) % nq * kRows;
      float* qsn = ring + 2 * ((it + 1) % 2) * TILE;
      load_rows<HD>(qsn, q, b, qn, S, H, hn);
      load_rows<HD>(qsn + TILE, dout, b, qn, S, H, hn);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // this tile's copies, every thread's, have landed

    // S^T and dP^T: rows keys ty + 16 i, columns query rows tx + 8 j
    float s[2][4], dp[2][4];
    // two steps of four d a turn: fewer loads live beside dK and dV
    chain_tile<HD, 2>(s, ks, qs);
    chain_tile<HD, 2>(dp, vs, dos);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            prob(s[i][j], sqrt_hd, lq[j],
                 visible(q0 + tx + 8 * j, k0 + ty + 16 * i, S, T_, causal,
                         window));
        dp[i][j] = p * (dp[i][j] - dd[j]);
        ps[(ty + 16 * i) * kLDP + tx + 8 * j] = p;
      }
    __syncthreads();   // P^T is complete
    product_tile<HD>(acc_dv, ps, dos);   // dV += P^T dO
    __syncthreads();   // P^T's readers are done: the tile takes dS^T
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * kLDP + tx + 8 * j] = dp[i][j];
    __syncthreads();
    product_tile<HD>(acc_dk, ps, qs);    // dK += dS^T Q (scaled at the end)
    __syncthreads();   // the stage's and the tile's readers are done
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= T_) continue;
    const int64_t off = ((int64_t(b) * T_ + t) * KV + kvh) * HD;
    store_row<HD>(dk + off, acc_dk[i], scale);
    store_row<HD>(dv + off, acc_dv[i], 1.0f);
  }
}

// 1. D of every (b, h, query tile), the heaviest tiles first.
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 4 : 1)
flash_bwd_delta_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta, int S, int T_, int H,
                       int KV, int causal, int window, float sqrt_hd) {
  dq_walk<HD, true>(q, k, v, dout, lse, delta, nullptr, S, T_, H, KV, causal,
                    window, sqrt_hd, 0.0f, blockIdx.x,
                    (gridDim.y - 1 - blockIdx.y) * kRows);
}

// 2. The dkdv blocks (n_kv of them, key tile 0, which sees the most rows,
// first), then the dq blocks, the heaviest query tiles first: one launch,
// so the two kinds share the SMs. Three blocks an SM at hd <= 64: the dq
// and dkdv bodies together take 154 registers (at four blocks, 128, with
// a spill, and slower).
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 3 : 1)
flash_bwd_grad_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      float* __restrict__ delta, float* __restrict__ dq,
                      float* __restrict__ dk, float* __restrict__ dv, int S,
                      int T_, int H, int KV, int causal, int window,
                      float sqrt_hd, float scale, int B, int n_kv) {
  const int i = blockIdx.x;
  if (i < n_kv) {
    dkdv_block<HD>(q, k, v, dout, lse, delta, dk, dv, S, T_, H, KV, causal,
                   window, sqrt_hd, scale, i % (B * KV),
                   i / (B * KV) * kRows);
  } else {
    const int j = i - n_kv;
    const int nq = (S + kRows - 1) / kRows;
    dq_walk<HD, false>(q, k, v, dout, lse, delta, dq, S, T_, H, KV, causal,
                       window, sqrt_hd, scale, j % (B * H),
                       (nq - 1 - j / (B * H)) * kRows);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv,
           int B, int S, int T_, int H, int KV, int causal, int window,
           cudaStream_t stream) {
  const int smem_d = dq_smem_floats<HD>() * static_cast<int>(sizeof(float));
  // the dkdv blocks' window is the larger
  const int smem_g =
      dkdv_smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_delta_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_d);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_grad_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_g);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float sqrt_hd = sqrtf(static_cast<float>(HD));
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  const int nq = (S + kRows - 1) / kRows;
  const int n_kv = B * KV * ((T_ + kRows - 1) / kRows);

  // D first: the dq and dkdv blocks read it
  flash_bwd_delta_kernel<HD><<<dim3(B * H, nq), kThreads, smem_d, stream>>>(
      qt, kt, vt, dot, lse, delta, S, T_, H, KV, causal, window, sqrt_hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_grad_kernel<HD><<<n_kv + B * H * nq, kThreads, smem_g, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), S, T_, H, KV, causal,
      window, sqrt_hd, scale, B, n_kv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16 route: wgmma fed by TMA

namespace tc {

constexpr int kKeysB = 128;    // keys per kernel-B block, 64 per consumer
constexpr int kStagesB = 3;    // kernel B's ring of query tiles
constexpr int kRowPad = 128;   // lse and D rows are padded to a multiple
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kKeysB == kBK, "kernel B's K and V tiles are Tile's kBK rows");

// Shared-memory geometry of kernels A and B at head dim HD (Tile's boxes).
template <int HD>
struct BwdTile {
  using L = Tile<HD>;
  static constexpr int BK = HD == 160 ? 64 : kBK;   // A's keys a stage
  static constexpr int BQ = HD == 160 ? 32 : 64;    // B's rows a stage
  // A: Q and dO (kBQ rows), then kStages stages of K, then of V (BK rows)
  static constexpr int kKBoxA = BK * L::kRowBytes;
  static constexpr int kKVBytesA = L::kBoxes * kKBoxA;
  static constexpr int kSmemA = 2 * L::kQBytes + 2 * kStages * kKVBytesA +
                                8 * (1 + 2 * kStages) + 1024;
  // B: K and V (kKeysB rows), kStagesB stages of Q, then of dO (BQ rows),
  // then of the lse and D rows (BQ floats each)
  static constexpr int kQBoxB = BQ * L::kRowBytes;
  static constexpr int kQBytesB = L::kBoxes * kQBoxB;
  static constexpr int kRowsB = 2 * BQ * 4;
  static constexpr int kSmemB = 2 * L::kKVBytes +
                                kStagesB * (2 * kQBytesB + kRowsB) +
                                8 * (1 + 2 * kStagesB) + 1024;
  static_assert(kSmemA <= 232448 && kSmemB <= 232448, "shared memory");
};

// d = A B^T (64 x N) over hd, A's 64 and B's N rows K-major in tiles whose
// boxes are ABOX and BBOX bytes: the forward's sequence, kk in hd order.
template <int HD, int N, int ABOX, int BBOX>
__device__ __forceinline__ void product_k_major(float (&d)[N / 2], uint32_t a,
                                                uint32_t b) {
  using L = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t box = (kk * 16) / L::kBoxCols;
    const uint32_t col = (kk * 16) % L::kBoxCols * 2;
    wgmma_ss<N>(d, desc_k_major<HD>(a + box * ABOX + col),
                desc_k_major<HD>(b + box * BBOX + col), kk > 0);
  }
}

// A float32 fragment (64 x 16 KS, rows and columns as wgmma's accumulator)
// rounded to bf16 as KS register A fragments: the accumulator's 16-column
// step kk is the A fragment of step kk.
template <int KS>
__device__ __forceinline__ void to_a_frags(const float (&x)[8 * KS],
                                           uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      a[kk][c] = bf16x2_bits(
          __floats2bfloat162_rn(x[8 * kk + 2 * c], x[8 * kk + 2 * c + 1]));
}

// Kernel A's S = Q K^T and dP = dO V^T for one stage's K and V tiles
// (BK keys), once the stage's loads have landed.
template <int HD>
__device__ __forceinline__ void scores_a(
    float (&s)[BwdTile<HD>::BK / 2], float (&dp)[BwdTile<HD>::BK / 2],
    uint32_t q_wg, uint32_t do_wg, uint32_t k_t, uint32_t v_t,
    uint32_t full, uint32_t parity) {
  using W = BwdTile<HD>;
  mbar_wait(full, parity);
  wgmma_fence();
  product_k_major<HD, W::BK, Tile<HD>::kQBox, W::kKBoxA>(s, q_wg, k_t);
  product_k_major<HD, W::BK, Tile<HD>::kQBox, W::kKBoxA>(dp, do_wg, v_t);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  fence_regs(dp);
}

// Whether some (row, key) of a consumer's 64 rows from r_lo by the BK keys
// from k0 is invisible: the diagonal, the window's edge, the ragged end of
// T. Only such tiles are masked per element.
template <int BK>
__device__ __forceinline__ bool edge_a(int k0, int r_lo, int T_, int causal,
                                       int window) {
  return k0 + BK > T_ || (causal && k0 + BK - 1 > r_lo) ||
         (window > 0 && r_lo + 63 - k0 >= window);
}

// P of one score (unscaled) given its row's lse in units of log2; 0 for an
// invisible (row, col) of an edge tile.
__device__ __forceinline__ float prob(float s, float scale_log2, float l2,
                                      bool edge, int row, int col, int S,
                                      int T_, int causal, int window) {
  const float p = exp2f(fminf(fmaf(s, scale_log2, -l2), 0.0f));
  return edge && !simt::visible(row, col, S, T_, causal, window) ? 0.0f : p;
}

// A: dQ, and D and lse log2(e) (rows padded to S_pad) for B.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const float* __restrict__ lse, float* __restrict__ lse2,
                    float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq,
                    int S, int S_pad, int T_, int H, int KV, int causal,
                    int window, float scale_log2, float scale) {
  using L = Tile<HD>;
  using W = BwdTile<HD>;
  constexpr int BK = W::BK;
  constexpr int NS = BK / 2;         // score registers a thread
  constexpr int KS = BK / 16;        // 16-key steps of a tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + L::kQBytes;
  const uint32_t k_s = do_s + L::kQBytes;           // stage st: + st * kKVBytesA
  const uint32_t v_s = k_s + kStages * W::kKVBytesA;
  const uint32_t q_full = v_s + kStages * W::kKVBytesA;
  const uint32_t kv_full = q_full + 8;               // + 8 st
  const uint32_t empty = kv_full + 8 * kStages;

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  // keys this query tile can see: [kv_begin, kv_end), as in the forward
  const int kv_end = causal ? min(T_, q0 + kBQ) : T_;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int n_tiles = (kv_end - kv_begin + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(kv_full + 8 * st, 1);
      mbar_init(empty + 8 * st, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: Q and dO once, then the key tiles twice (walks 1 and 2)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::kQBytes);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load(q_s + c * L::kQBox, &tm_q, q_full, c * L::kBoxCols, h, q0,
                 b);
        tma_load(do_s + c * L::kQBox, &tm_do, q_full, c * L::kBoxCols, h, q0,
                 b);
      }
      for (int i = 0; i < 2 * n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t parity = (i / kStages) & 1;
        const int k0 = kv_begin + (i % n_tiles) * BK;
        mbar_wait(empty + 8 * st, parity ^ 1);   // round 0 passes at once
        mbar_expect_tx(kv_full + 8 * st, 2 * W::kKVBytesA);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load(k_s + st * W::kKVBytesA + c * W::kKBoxA, &tm_k,
                   kv_full + 8 * st, c * L::kBoxCols, kvh, k0, b);
          tma_load(v_s + st * W::kKVBytesA + c * W::kKBoxA, &tm_v,
                   kv_full + 8 * st, c * L::kBoxCols, kvh, k0, b);
        }
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
    const uint32_t do_wg = do_s + 64 * (wg - 1) * L::kRowBytes;
    const int64_t bh = int64_t(b) * H + h;
    // lse of rows row0 and row0 + 8 in units of log2 (0 past S, where Q
    // and dO are zero-filled, so P dP and dS are 0)
    float l2[2], d[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      l2[r] = row < S ? lse[bh * S + row] * kLog2e : 0.0f;
    }
    mbar_wait(q_full, 0);

    // walk 1: D_r = sum_c P_rc dP_rc
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const int k0 = kv_begin + i * BK;
      float s[NS], dp[NS];
      scores_a<HD>(s, dp, q_wg, do_wg, k_s + st * W::kKVBytesA,
                   v_s + st * W::kKVBytesA, kv_full + 8 * st,
                   (i / kStages) & 1);
      mbar_arrive(empty + 8 * st);   // K and V are no longer read
      const bool edge = edge_a<BK>(k0, r_lo, T_, causal, window);
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = prob(s[4 * j + e], scale_log2, l2[r], edge,
                               row0 + 8 * r, k0 + 8 * j + col0 + (e & 1), S,
                               T_, causal, window);
          d[r] = fmaf(p, dp[4 * j + e], d[r]);
        }
    }
    // each quad's four partial sums in a fixed order
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      d[r] += __shfl_xor_sync(0xffffffffu, d[r], 1);
      d[r] += __shfl_xor_sync(0xffffffffu, d[r], 2);
      // every row of the tile lies below S_pad; past S, 0 and 0
      if (col0 == 0) {
        lse2[bh * S_pad + row0 + 8 * r] = l2[r];
        dsum[bh * S_pad + row0 + 8 * r] = d[r];
      }
    }

    // walk 2: dS = P (dP - D), dQ += dS K with K MN-major (N = hd)
    float acc[HD / 2];
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) acc[x] = 0.0f;
    for (int i = n_tiles; i < 2 * n_tiles; ++i) {
      const int st = i % kStages;
      const int k0 = kv_begin + (i - n_tiles) * BK;
      const uint32_t k_t = k_s + st * W::kKVBytesA;
      float s[NS], dp[NS];
      scores_a<HD>(s, dp, q_wg, do_wg, k_t, v_s + st * W::kKVBytesA,
                   kv_full + 8 * st, (i / kStages) & 1);
      const bool edge = edge_a<BK>(k0, r_lo, T_, causal, window);
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = prob(s[4 * j + e], scale_log2, l2[r], edge,
                               row0 + 8 * r, k0 + 8 * j + col0 + (e & 1), S,
                               T_, causal, window);
          s[4 * j + e] = p * (dp[4 * j + e] - d[r]);
        }
      uint32_t ds[KS][4];
      to_a_frags<KS>(s, ds);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_pv<HD>(acc, ds[kk],
                     desc_mn_major_rows<HD, BK>(k_t + kk * 16 * L::kRowBytes));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(ds);
      mbar_arrive(empty + 8 * st);   // K is no longer read
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      __nv_bfloat16* dst = dq + ((int64_t(b) * S + row) * H + h) * HD + col0;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale,
                                  acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// B: dK and dV of one query head h over a 128-key tile: to dk, dv when
// H == KV, else (scaled, float32) to partial (2, B, T, H, hd).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const float* __restrict__ lse2,
                      const float* __restrict__ dsum,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv,
                      float* __restrict__ partial, int S, int S_pad, int T_,
                      int H, int KV, int causal, int window,
                      float scale_log2, float scale) {
  using L = Tile<HD>;
  using W = BwdTile<HD>;
  constexpr int BQ = W::BQ;
  constexpr int NS = BQ / 2;         // score registers a thread
  constexpr int KS = BQ / 16;        // 16-row steps of a query tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t k_s = (base + 1023u) & ~1023u;
  const uint32_t v_s = k_s + L::kKVBytes;
  const uint32_t q_s = v_s + L::kKVBytes;           // stage st: + st * kQBytesB
  const uint32_t do_s = q_s + kStagesB * W::kQBytesB;
  const uint32_t rows_s = do_s + kStagesB * W::kQBytesB;   // + st * kRowsB
  const uint32_t kv_full = rows_s + kStagesB * W::kRowsB;
  const uint32_t full = kv_full + 8;                 // + 8 st
  const uint32_t empty = full + 8 * kStagesB;

  const int h = blockIdx.x;
  const int k0 = blockIdx.y * kKeysB;   // the first key tiles see most rows
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  // query rows that see a key of this tile: [q_begin, q_end)
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + kKeysB - 1 + window) : S;
  const int n_tiles = (q_end - q_begin + BQ - 1) / BQ;
  const int64_t bh = int64_t(b) * H + h;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStagesB; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: K and V once, then each query tile's Q, dO, lse and D
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKVBytes);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load(k_s + c * L::kKBox, &tm_k, kv_full, c * L::kBoxCols, kvh, k0,
                 b);
        tma_load(v_s + c * L::kKBox, &tm_v, kv_full, c * L::kBoxCols, kvh, k0,
                 b);
      }
      const float* l_row = lse2 + bh * S_pad + q_begin;
      const float* d_row = dsum + bh * S_pad + q_begin;
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStagesB;
        const int q0 = q_begin + i * BQ;
        const uint32_t bar = full + 8 * st;
        mbar_wait(empty + 8 * st, ((i / kStagesB) & 1) ^ 1);
        mbar_expect_tx(bar, 2 * W::kQBytesB + W::kRowsB);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load(q_s + st * W::kQBytesB + c * W::kQBoxB, &tm_q, bar,
                   c * L::kBoxCols, h, q0, b);
          tma_load(do_s + st * W::kQBytesB + c * W::kQBoxB, &tm_do, bar,
                   c * L::kBoxCols, h, q0, b);
        }
        bulk_load(rows_s + st * W::kRowsB, l_row + i * BQ, BQ * 4, bar);
        bulk_load(rows_s + st * W::kRowsB + BQ * 4, d_row + i * BQ, BQ * 4,
                  bar);
      }
    }
  } else {
    // consumers: warpgroup wg - 1 owns keys k0 + 64 (wg - 1) + [0, 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lt = threadIdx.x % 128;
    const int c_lo = k0 + 64 * (wg - 1);
    const int key0 = c_lo + 16 * (lt / 32) + (lt % 32) / 4;  // and key0 + 8
    const int col0 = 2 * (lt % 4);
    const uint32_t k_wg = k_s + 64 * (wg - 1) * L::kRowBytes;
    const uint32_t v_wg = v_s + 64 * (wg - 1) * L::kRowBytes;

    float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) dk_acc[x] = dv_acc[x] = 0.0f;
    mbar_wait(kv_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStagesB;
      const int q0 = q_begin + i * BQ;
      const uint32_t q_t = q_s + st * W::kQBytesB;
      const uint32_t do_t = do_s + st * W::kQBytesB;
      const float* l2 = reinterpret_cast<const float*>(
          smem_raw + (rows_s - base) + st * W::kRowsB);
      const float* dd = l2 + BQ;

      // S^T = K Q^T and dP^T = V dO^T: rows keys, columns query rows
      float s[NS], dp[NS];
      mbar_wait(full + 8 * st, (i / kStagesB) & 1);
      wgmma_fence();
      product_k_major<HD, BQ, L::kKBox, W::kQBoxB>(s, k_wg, q_t);
      product_k_major<HD, BQ, L::kKBox, W::kQBoxB>(dp, v_wg, do_t);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // P^T and dS^T = P^T (dP^T - D) in place; masked per element only
      // where some (key, row) of the 64 x BQ block is invisible
      const bool edge = c_lo + 64 > T_ || q0 + BQ > S ||
                        (causal && c_lo + 63 > q0) ||
                        (window > 0 && q0 + BQ - 1 - c_lo >= window);
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + col0 + (e & 1);
          const float p = prob(s[4 * j + e], scale_log2, l2[col], edge,
                               q0 + col, key0 + 8 * (e >> 1), S, T_, causal,
                               window);
          s[4 * j + e] = p;
          dp[4 * j + e] = p * (dp[4 * j + e] - dd[col]);
        }
      uint32_t pa[KS][4], dsa[KS][4];
      to_a_frags<KS>(s, pa);
      to_a_frags<KS>(dp, dsa);

      // dV += P^T dO and dK += dS^T Q, dO and Q MN-major (N = hd)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        wgmma_pv<HD>(dv_acc, pa[kk], desc_mn_major_rows<HD, BQ>(
                                         do_t + kk * 16 * L::kRowBytes));
        wgmma_pv<HD>(dk_acc, dsa[kk], desc_mn_major_rows<HD, BQ>(
                                          q_t + kk * 16 * L::kRowBytes));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      fence_regs(pa);
      fence_regs(dsa);
      mbar_arrive(empty + 8 * st);   // this thread is done with the stage
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = key0 + 8 * r;
      if (t >= T_) continue;
      if (partial == nullptr) {
        const int64_t off = ((int64_t(b) * T_ + t) * KV + kvh) * HD + col0;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
              __floats2bfloat162_rn(dk_acc[4 * j + 2 * r] * scale,
                                    dk_acc[4 * j + 2 * r + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
              __floats2bfloat162_rn(dv_acc[4 * j + 2 * r],
                                    dv_acc[4 * j + 2 * r + 1]);
        }
      } else {
        const int64_t off = ((int64_t(b) * T_ + t) * H + h) * HD + col0;
        const int64_t part = int64_t(gridDim.z) * T_ * H * HD;   // dV's
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          *reinterpret_cast<float2*>(partial + off + 8 * j) =
              make_float2(dk_acc[4 * j + 2 * r] * scale,
                          dk_acc[4 * j + 2 * r + 1] * scale);
          *reinterpret_cast<float2*>(partial + part + off + 8 * j) =
              make_float2(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// C: dK (blockIdx.y 0) or dV (1), (B, T, KV, hd) bf16, from B's float32
// partials (2, B, T, H, hd): each kv head's G = H / KV query heads summed
// in head order, rounded once. n counts float4 groups of one output.
__global__ void __launch_bounds__(256)
sum_group_heads(const float4* __restrict__ partial,
                __nv_bfloat162* __restrict__ dk,
                __nv_bfloat162* __restrict__ dv, int64_t n, int G, int hd4) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // (b, t, kv head) row i / hd4; its G heads are G consecutive rows
  const float4* src =
      partial + blockIdx.y * n * G + (i / hd4) * G * hd4 + i % hd4;
  float4 acc = src[0];
  for (int g = 1; g < G; ++g) {
    const float4 x = src[g * hd4];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  __nv_bfloat162* dst = blockIdx.y == 0 ? dk : dv;
  dst[2 * i] = __floats2bfloat162_rn(acc.x, acc.y);
  dst[2 * i + 1] = __floats2bfloat162_rn(acc.z, acc.w);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, float* rows, float* partial, void* dq, void* dk,
           void* dv, int B, int S, int T_, int H, int KV, int causal,
           int window, cudaStream_t stream) {
  using L = Tile<HD>;
  using W = BwdTile<HD>;
  if (H > KV && partial == nullptr) return -1;
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_qb, tm_dob, tm_kb, tm_vb;
  if (!encode_map(&tm_q, q, B, S, H, HD, L::kBoxCols, kBQ) ||
      !encode_map(&tm_do, dout, B, S, H, HD, L::kBoxCols, kBQ) ||
      !encode_map(&tm_k, k, B, T_, KV, HD, L::kBoxCols, W::BK) ||
      !encode_map(&tm_v, v, B, T_, KV, HD, L::kBoxCols, W::BK) ||
      !encode_map(&tm_qb, q, B, S, H, HD, L::kBoxCols, W::BQ) ||
      !encode_map(&tm_dob, dout, B, S, H, HD, L::kBoxCols, W::BQ) ||
      !encode_map(&tm_kb, k, B, T_, KV, HD, L::kBoxCols, kKeysB) ||
      !encode_map(&tm_vb, v, B, T_, KV, HD, L::kBoxCols, kKeysB))
    return -2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      W::kSmemA);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             W::kSmemB);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int S_pad = (S + kRowPad - 1) / kRowPad * kRowPad;
  float* lse2 = rows;
  float* dsum = rows + int64_t(B) * H * S_pad;
  const double rsqrt_hd = 1.0 / sqrt(static_cast<double>(HD));
  const float scale = static_cast<float>(rsqrt_hd);
  const float scale_log2 = static_cast<float>(1.4426950408889634 * rsqrt_hd);
  auto* dk_t = static_cast<__nv_bfloat16*>(dk);
  auto* dv_t = static_cast<__nv_bfloat16*>(dv);

  // A first: it writes the lse and D rows that B reads
  flash_bwd_dq_kernel<HD><<<dim3(H, (S + kBQ - 1) / kBQ, B), kThreads,
                            W::kSmemA, stream>>>(
      tm_q, tm_do, tm_k, tm_v, lse, lse2, dsum,
      static_cast<__nv_bfloat16*>(dq), S, S_pad, T_, H, KV, causal, window,
      scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<HD><<<dim3(H, (T_ + kKeysB - 1) / kKeysB, B),
                              kThreads, W::kSmemB, stream>>>(
      tm_qb, tm_dob, tm_kb, tm_vb, lse2, dsum, dk_t, dv_t,
      H > KV ? partial : nullptr, S, S_pad, T_, H, KV, causal, window,
      scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || H == KV) return static_cast<int>(err);
  const int64_t n = int64_t(B) * T_ * KV * HD / 4;
  sum_group_heads<<<dim3(static_cast<unsigned>((n + 255) / 256), 2), 256, 0,
                    stream>>>(reinterpret_cast<const float4*>(partial),
                              reinterpret_cast<__nv_bfloat162*>(dk_t),
                              reinterpret_cast<__nv_bfloat162*>(dv_t), n,
                              H / KV, HD / 4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// The route is chosen by dtype: float32 on CUDA cores, bfloat16 on tensor
// cores. Each dtype has exactly one route; neither falls back to the other.
template <int HD>
int launch_route(int dtype, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, float* delta,
                 float* partial, void* dq, void* dk, void* dv, int B, int S,
                 int T_, int H, int KV, int causal, int window,
                 cudaStream_t stream) {
  if (dtype == 0)
    return simt::launch<HD>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, T_,
                            H, KV, causal, window, stream);
  if (dtype == 1)
    return tc::launch<HD>(q, k, v, dout, lse, delta, partial, dq, dk, dv, B,
                          S, T_, H, KV, causal, window, stream);
  return -1;
}

}  // namespace

// C interface, bound with ctypes (kernels/flash_attention/kernel.py).
// q, dout, dq (B, S, H, hd); k, v, dk, dv (B, T, KV, hd), T == S; all
// contiguous and of one type: dtype 0 = float32 (the CUDA-core route),
// 1 = bfloat16 (the tensor-core route); q, k, v and dout 16-byte aligned
// (TMA and cp.async read them), dq, dk and dv too (float4 stores). lse
// is the forward's (B, H, S) float32.
// delta is float32 scratch that the call writes: (B, H, S) floats (D) for
// float32; for bfloat16 2 B H S_pad floats (lse log2(e) and D, rows padded
// to S_pad = S rounded up to a multiple of 128, 16-byte aligned). partial
// is float32 scratch of 2 B T H hd floats (each query head's dK and dV),
// needed by bfloat16 when H > KV, else unused (may be null). hd is 32, 64,
// 128 or 160 and H a multiple of KV.
// Launches two kernels (three for bfloat16 with H > KV) on `stream`;
// returns cudaGetLastError() after each (0 = launched), -1 for a shape or
// type it does not take, or -2 when the TMA tensor maps cannot be encoded.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, void* delta,
                                   void* partial, void* dq, void* dk,
                                   void* dv, int dtype, int B, int S, int T,
                                   int H, int KV, int hd, int causal,
                                   int window, void* stream) {
  if (B <= 0 || S <= 0 || T != S || KV <= 0 || H % KV != 0) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  float* p = static_cast<float*>(partial);
  switch (hd) {
    case 32:
      return launch_route<32>(dtype, q, k, v, dout, l, d, p, dq, dk, dv, B,
                              S, T, H, KV, causal, window, st);
    case 64:
      return launch_route<64>(dtype, q, k, v, dout, l, d, p, dq, dk, dv, B,
                              S, T, H, KV, causal, window, st);
    case 128:
      return launch_route<128>(dtype, q, k, v, dout, l, d, p, dq, dk, dv, B,
                               S, T, H, KV, causal, window, st);
    case 160:
      return launch_route<160>(dtype, q, k, v, dout, l, d, p, dq, dk, dv, B,
                               S, T, H, KV, causal, window, st);
    default:
      return -1;
  }
}
