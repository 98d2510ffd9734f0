// Hopper building blocks of the flash attention kernels' bfloat16 routes
// (flash_attention.cu's forward, flash_attention_bwd.cu's backward): the
// forward's tile geometry, mbarrier and TMA helpers, wgmma shared-memory
// descriptors and instruction wrappers, and the host's tensor-map encoding.
// Each .cu includes it into its own anonymous namespace `tc`, so a kernel's
// symbols stay private to its library.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstring>

namespace {
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

// `bytes` contiguous bytes of global memory into shared memory (both 16 B
// aligned, `bytes` a multiple of 16); completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
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

// The MN-major operand of a tile of ROWS rows (desc_mn_major's, whose tile
// has kBK): the next kBoxCols hd columns lie one ROWS-row box on.
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t desc_mn_major_rows(uint32_t addr) {
  return smem_desc<HD>(addr, ROWS * Tile<HD>::kRowBytes,
                       8 * Tile<HD>::kRowBytes);
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

// _ss at N = 32 and 64 (m64n128k16_ss's form): d's N / 2 registers, then
// A's and B's descriptors (placeholders AB) and the scale-d flag (SCALE).
#define WGMMA_SS(N, D_OPS, D_PH, AB, SCALE)                                   \
  __device__ __forceinline__ void wgmma_m64n##N##k16_ss(                      \
      float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {             \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"           \
                 "wgmma.mma_async.sync.aligned.m64n" #N                       \
                 "k16.f32.bf16.bf16 {" D_PH "}, " AB ", p, 1, 1, 0, 0;\n}\n"  \
                 : D_OPS                                                      \
                 : "l"(da), "l"(db), "r"(scale_d));                           \
  }
WGMMA_SS(32, WGMMA_D16(0), WGMMA_P16, "%16, %17", "%18")
WGMMA_SS(64, WGMMA_D32, WGMMA_P32, "%32, %33", "%34")
#undef WGMMA_SS
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

// D (64 x N) (+)= A B^T for K-major A and B in shared memory, N = 32, 64
// or 128 (the backward's score tiles).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 32) wgmma_m64n32k16_ss(d, da, db, scale_d);
  if constexpr (N == 64) wgmma_m64n64k16_ss(d, da, db, scale_d);
  if constexpr (N == 128) wgmma_m64n128k16_ss(d, da, db, scale_d);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  uint32_t u;
  memcpy(&u, &x, sizeof(u));
  return u;
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

}  // namespace tc
}  // namespace
