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
// float32: CUDA cores (namespace simt), the first design of this kernel,
// kept as it was: the float32 parity bounds of the on-card checks were set
// against it, and a float32 product on tensor cores would need a 3xTF32
// split. One block of 256 threads owns one (b, h, 64-row query tile),
// staging 64-key tiles through shared memory; the online-softmax state
// lives in registers: thread (ty, tx) of the 16 x 16 layout owns rows
// ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and output columns
// tx + 16 j (j < hd / 16); a row's statistics reduce over the 16 lanes of
// its half-warp with shuffles. Tiles wholly above the causal diagonal or
// before the window are never loaded. Rows past S are masked here, not
// padded by the caller. Shared-memory rows of q and k are padded to hd + 1
// floats so the 16 lanes reading 16 key rows hit 16 banks. It multiplies
// with plain float32 FMAs (67 TFLOP/s peak).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstring>

namespace {

// ---------------------------------------------------------------------------
// float32 route: CUDA-core FMAs

namespace simt {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per shared-memory tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLDP = kBK + 1;   // padded row of the probability tile

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16 route: wgmma fed by TMA

namespace tc {

constexpr int kBQ = 128;        // query rows per block, 64 per consumer
constexpr int kBK = 128;        // keys per ring stage
constexpr int kStages = 2;
constexpr int kThreads = 384;   // producer warpgroup + two consumers

// Shared-memory geometry for head dim HD: a tile is kBoxes boxes of
// kBoxCols bf16 columns, each row kRowBytes long and swizzled in groups of
// 8 rows, as TMA writes it and wgmma's descriptors read it. A box is as
// wide as one swizzle span: 64 columns where HD is a multiple of 64, else
// 32 (HD = 32 and 160), so every box of a tile shares one swizzle and one
// descriptor layout.
template <int HD>
struct Tile {
  static constexpr int kBoxCols = HD % 64 == 0 ? 64 : 32;
  static_assert(HD % kBoxCols == 0, "hd must be a multiple of 32");
  static constexpr int kRowBytes = 2 * kBoxCols;           // swizzle width
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr int kQBox = kBQ * kRowBytes;
  static constexpr int kKBox = kBK * kRowBytes;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKBox;         // one K or V tile
  static constexpr int kBarBytes = 8 * (1 + 3 * kStages);
  // + 1024: the dynamic window is aligned up to the 1024 B swizzle atom
  static constexpr int kSmem =
      kQBytes + 2 * kStages * kKVBytes + kBarBytes + 1024;
  // wgmma descriptor layout type: 1 = 128 B swizzle, 2 = 64 B
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map (hd, heads, seq, batch) into shared memory;
// completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (all in 16 B units) and the swizzle layout type.
template <int HD>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         Tile<HD>::kLayout << 62;
}

// K-major operand (rows of hd, Q or K): the 16 columns at `addr`; the
// next 8 rows lie 8 swizzled rows on. LBO is unused for swizzled K-major.
template <int HD>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return smem_desc<HD>(addr, 16, 8 * Tile<HD>::kRowBytes);
}

// MN-major operand (V: 16 key rows at `addr`, N = hd contiguous): the next
// 8 keys lie 8 rows on (SBO); the next kBoxCols hd columns (one swizzle
// span) in the next box (LBO).
template <int HD>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return smem_desc<HD>(addr, Tile<HD>::kKBox, 8 * Tile<HD>::kRowBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins registers that an in-flight wgmma reads or writes: the compiler
// may neither move their uses across the wait nor reuse them before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x N, float32 fragment) (+)= A (64 x 16) B (16 x N). _ss: A and B
// K-major in shared memory; _rs: A in registers, B MN-major in shared
// memory. The fragment of thread t of the warpgroup holds, for each 8
// columns j, rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns
// 8 j + 2 (t % 4) (+ 1): d[4 j + 2 (row half) + (column parity)].
//
// The N / 2 accumulator registers are the asm's first operands: WGMMA_Dn
// lists their constraints and WGMMA_Pn their placeholders "%0, ...".
#define WGMMA_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WGMMA_D16(i) \
  WGMMA_D4(i), WGMMA_D4(i + 4), WGMMA_D4(i + 8), WGMMA_D4(i + 12)
#define WGMMA_D32 WGMMA_D16(0), WGMMA_D16(16)
#define WGMMA_D64 WGMMA_D32, WGMMA_D16(32), WGMMA_D16(48)
#define WGMMA_D80 WGMMA_D64, WGMMA_D16(64)
#define WGMMA_P16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define WGMMA_P32                                                          \
  WGMMA_P16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
            "%28, %29, %30, %31"
#define WGMMA_P64                                                           \
  WGMMA_P32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
            "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
            "%56, %57, %58, %59, %60, %61, %62, %63"
#define WGMMA_P80                                                           \
  WGMMA_P64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, " \
            "%76, %77, %78, %79"

__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WGMMA_P64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D64
      : "l"(da), "l"(db), "r"(scale_d));
}

// _rs at N = hd, always adding to d; A's four registers, B's descriptor
// and the scale-d flag follow d: placeholders A_DESC and SCALE.
#define WGMMA_RS(N, D_OPS, D_PH, A_DESC, SCALE)                               \
  __device__ __forceinline__ void wgmma_m64n##N##k16_rs(                      \
      float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {               \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"           \
                 "wgmma.mma_async.sync.aligned.m64n" #N                       \
                 "k16.f32.bf16.bf16 {" D_PH "}, " A_DESC ", p, 1, 1, 1;\n}\n" \
                 : D_OPS                                                      \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),       \
                   "r"(1));                                                   \
  }
WGMMA_RS(32, WGMMA_D16(0), WGMMA_P16, "{%16, %17, %18, %19}, %20", "%21")
WGMMA_RS(64, WGMMA_D32, WGMMA_P32, "{%32, %33, %34, %35}, %36", "%37")
WGMMA_RS(128, WGMMA_D64, WGMMA_P64, "{%64, %65, %66, %67}, %68", "%69")
WGMMA_RS(160, WGMMA_D80, WGMMA_P80, "{%80, %81, %82, %83}, %84", "%85")
#undef WGMMA_RS
#undef WGMMA_P80
#undef WGMMA_P64
#undef WGMMA_P32
#undef WGMMA_P16
#undef WGMMA_D80
#undef WGMMA_D64
#undef WGMMA_D32
#undef WGMMA_D16
#undef WGMMA_D4

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 32) wgmma_m64n32k16_rs(o, a, db);
  if constexpr (HD == 64) wgmma_m64n64k16_rs(o, a, db);
  if constexpr (HD == 128) wgmma_m64n128k16_rs(o, a, db);
  if constexpr (HD == 160) wgmma_m64n160k16_rs(o, a, db);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  uint32_t u;
  memcpy(&u, &x, sizeof(u));
  return u;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ out, int S, int T_, int H,
                       int KV, int causal, int window, float scale_log2) {
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
      __nv_bfloat16* dst = out + ((int64_t(b) * S + row) * H + h) * HD + col0;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / denom,
                                  o[4 * j + 2 * r + 1] / denom);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda).
// Only a successful lookup is kept: a failed one returns nullptr (the
// launch then returns -2) and is tried again at the next launch.
EncodeTiled encode_tiled() {
  static std::atomic<EncodeTiled> found{nullptr};
  EncodeTiled fn = found.load(std::memory_order_acquire);
  if (fn != nullptr) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult status{};
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
  if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) {
    cudaGetLastError();   // not left for the next launch's check to report
    return nullptr;
  }
  fn = reinterpret_cast<EncodeTiled>(p);
  found.store(fn, std::memory_order_release);
  return fn;
}

// 4-D map over a contiguous bf16 (batch, seq, heads, hd) tensor, innermost
// first; a box is `rows` positions of one head by `cols` of hd.
bool encode_map(CUtensorMap* map, const void* ptr, int batch, int seq,
                int heads, int hd, int cols, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(heads),
                              cuuint64_t(seq), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(hd) * 2,
                                 cuuint64_t(heads) * hd * 2,
                                 cuuint64_t(seq) * heads * hd * 2};
  const cuuint32_t box[4] = {cuuint32_t(cols), 1, cuuint32_t(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_, int H, int KV, int causal, int window,
           cudaStream_t stream) {
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
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), S, T_, H, KV,
      causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// The route is chosen by dtype: float32 on CUDA cores, bfloat16 on tensor
// cores. Each dtype has exactly one route; neither falls back to the other.
template <int HD>
int launch_route(const void* q, const void* k, const void* v, void* out,
                 int dtype, int B, int S, int T_, int H, int KV, int causal,
                 int window, cudaStream_t stream) {
  if (dtype == 0)
    return simt::launch<float, HD>(q, k, v, out, B, S, T_, H, KV, causal,
                                   window, stream);
  if (dtype == 1)
    return tc::launch<HD>(q, k, v, out, B, S, T_, H, KV, causal, window,
                          stream);
  return -1;
}

}  // namespace

// C interface, bound with ctypes (kernels/flash_attention/kernel.py).
// q (B, S, H, hd), k and v (B, T, KV, hd), out (B, S, H, hd), all
// contiguous and of one type: dtype 0 = float32 (the CUDA-core route),
// 1 = bfloat16 (the tensor-core route, whose q, k and v must be 16-byte
// aligned for TMA). hd is 32, 64, 128 or 160 and H a multiple of KV.
// Launches on `stream`; returns cudaGetLastError() (0 = launched), -1 for
// a shape or type it does not take, or -2 when the TMA tensor maps cannot
// be encoded.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int dtype,
                                   int B, int S, int T, int H, int KV,
                                   int hd, int causal, int window,
                                   void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KV <= 0 || H % KV != 0) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch_route<32>(q, k, v, out, dtype, B, S, T, H, KV, causal,
                              window, st);
    case 64:
      return launch_route<64>(q, k, v, out, dtype, B, S, T, H, KV, causal,
                              window, st);
    case 128:
      return launch_route<128>(q, k, v, out, dtype, B, S, T, H, KV, causal,
                               window, st);
    case 160:
      return launch_route<160>(q, k, v, out, dtype, B, S, T, H, KV, causal,
                               window, st);
    default:
      return -1;
  }
}
