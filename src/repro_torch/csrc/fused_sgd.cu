// Lane-stacked fused momentum-SGD update for Hopper (sm_90a), reading the
// gradient from autograd's leaves in place.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/fused_sgd/kernel.py::fused_sgd_flat (body _fused_sgd_kernel),
// together with what surrounds it on the FL main path: the ravel_pytree of
// the gradients, the (1 - reset) * m momentum reset of
// core/local.py::_run_hops, the padded flat kernel -> where(ok) select of
// masked_momentum_update, and the pad-to-tile wrapper of ops.py.
//
// One launch updates the whole (C, P) lane stack of one SGD step, in place:
//   m_in = reset ? 0 : m
//   m'   = mu * m_in + g
//   d    = nesterov ? g + mu * m' : m'
//   p'   = p - lr * d
// Lanes with ok[c] == 0 keep p and take m = m_in (so a visit start still
// zeroes their momentum, as in the reference scan); their p, g and m are
// never read. lr is read from device memory (a (1,) float tensor), so a
// scheduled lr needs no host round trip.
//
// The gradient is a list of at most 16 leaves. Leaf k is a contiguous
// (C, size_k) tensor that holds elements [off_k, off_k + size_k) of every
// lane's row, in the sorted-leaf layout of utils/tree.py; the sizes sum to
// P. A single (C, P) tensor is the one-leaf case. The kernel reads each leaf
// where autograd wrote it, so no pass concatenates them first.
//
// Bound: memory. Per element the update reads p, g, m (12 B) and writes p, m
// (8 B): 20 B for 4 flops, far below the H100's ~20 flop/B balance point, so
// the least time is 20 * C * P bytes over the card's memory rate (C=5,
// P=199,210: 19.9 MB -> about 6 us at 3.35 TB/s).
//
// Design. p and m are one flat range of C * P elements. It is cut into
// (lane, leaf) segments, and each segment into spans of `span` elements
// (kSpan by default); one block updates one span, on a 1-D grid of the
// spans of every segment (no lane limit). A block decodes its lane, leaf
// and span from its index and loads ok[lane] and lr first, so every block
// has its loads in flight one round trip after it starts; at 32 registers
// a thread the paper MLP's whole grid (5 x 202 blocks) is resident at once.
// Spans are cut on p's 16-byte grid: only a segment's first span has a
// head of 0-3 elements before that grid and only its last a tail of 0-3
// after it, so the blocks between write whole 16-byte vectors of p and m.
// Each thread takes one item (a head or tail element, or a 16-byte slot),
// so no thread waits on a second round trip. The gradient's offset against
// p is the same across a segment, so g is loaded 16 bytes at a time where
// the two agree modulo 16, in two 8-byte halves where they agree modulo 8
// (lanes 0, 2 and 4 of the paper MLP's w0), else element by element. g is
// dead after the update, so its loads carry an L2 evict-first policy; p
// and m keep the default, as the next forward pass and the next update
// read them again. Under reset m is not read.
//
// Measured at the paper MLP's shape (PERF.md): persistent grids
// that stream several slots a thread (a register ring of 2-8 slots, a
// cp.async ring in shared memory, a shared segment table) lost to this
// one-wave grid; so did a flat stream of 2 to 8 blocks an SM whose spans
// cross segment boundaries (a block that meets two segments waits on two
// round trips, and at 8 blocks an SM its 32-register cap spills), and
// spans cut off p's grid, which gave every span of a lane starting off
// the grid its own head and tail.
//
// Every multiply and add is an explicitly rounded intrinsic, so nvcc cannot
// contract p - lr * d into an FMA: the kernel matches its plain PyTorch
// version (kernels/fused_sgd/ref.py) bit for bit.
//
// bfloat16 (fused_sgd_lanes_bf16; the reference's fused_sgd_flat at
// p.dtype = bfloat16, as launch/steps.py::make_train_step calls it with
// bfloat16 parameters). p, m, the leaves and lr are bfloat16, and the
// reference rounds to bfloat16 after every operation, mu and lr included
// (mu is a weakly typed Python float, lr is cast to p.dtype):
//   m' = bf16(bf16(mu * m_in) + g)
//   d  = nesterov ? bf16(g + bf16(mu * m')) : m'
//   p' = bf16(p - bf16(lr * d))
// each operation in float32 (a product of two bfloat16 values is exact
// there), mu rounded to bfloat16 on the host. Bound: memory, 10 B an
// element (read p, g, m, write p, m). Same grid as the float32 kernel:
// a block per span of a (lane, leaf) segment, spans cut on p's 16-byte
// grid, so the blocks between a segment's first and last move whole
// 8-element vectors of p and m; g is loaded 16 bytes at a time where it
// shares p's alignment, else element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSpan = 1000;  // elements a block: at most 256 items
constexpr int kMaxLeaves = 16;

constexpr int kSpanBf16 = 2048;  // elements a block: 256 8-element slots

template <typename T>
struct LeafTable {
  const T* ptr[kMaxLeaves];
  long long size[kMaxLeaves];
  long long off[kMaxLeaves];    // leaf k's first element within a row
  long long first[kMaxLeaves];  // leaf k's first block within a lane
  long long n;                  // P
  long long span;               // elements a block
  int count;
};
using Leaves = LeafTable<float>;

// The leaf table of a launch and its blocks a lane; false for a table or
// span the kernels do not take. span is rounded up to a multiple of
// `align`, the elements of one 16-byte vector (0: `dflt`).
template <typename T>
bool make_table(LeafTable<T>& leaves, long long& blocks,
                const T* const* leaf_ptrs, const long long* leaf_sizes,
                int num_leaves, long long n, int span, int align,
                int dflt) {
  if (num_leaves < 1 || num_leaves > kMaxLeaves || span < 0) return false;
  leaves = LeafTable<T>{};
  leaves.span = span > 0 ? (span + align - 1) / align * align : dflt;
  long long off = 0;
  blocks = 0;
  for (int k = 0; k < num_leaves; ++k) {
    if (leaf_sizes[k] < 1) return false;
    leaves.ptr[k] = leaf_ptrs[k];
    leaves.size[k] = leaf_sizes[k];
    leaves.off[k] = off;
    leaves.first[k] = blocks;
    off += leaf_sizes[k];
    blocks += (leaf_sizes[k] + leaves.span - 1) / leaves.span;
  }
  if (off != n) return false;
  leaves.n = n;
  leaves.count = num_leaves;
  return true;
}

__device__ __forceinline__ void sgd_one(float& p, float g, float& m, float lr,
                                        float mu, bool nesterov, bool reset) {
  const float m_in = reset ? 0.0f : m;
  const float m_new = __fadd_rn(__fmul_rn(mu, m_in), g);
  const float d = nesterov ? __fadd_rn(g, __fmul_rn(mu, m_new)) : m_new;
  p = __fsub_rn(p, __fmul_rn(lr, d));
  m = m_new;
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
      : "=l"(policy));
  return policy;
}

// g, read once: through the non-coherent path with L2 evict-first.
__device__ __forceinline__ float load_g1(const float* a, uint64_t policy) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v) : "l"(a), "l"(policy));
  return v;
}

// Four g values at a: 16-byte aligned (a16 == 0), 8-byte aligned
// (a16 == 8), or neither.
__device__ __forceinline__ float4 load_g4(const float* a, unsigned a16,
                                          uint64_t policy) {
  float4 v;
  if (a16 == 0) {
    asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(a), "l"(policy));
  } else if (a16 == 8) {
    asm("ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;"
        : "=f"(v.x), "=f"(v.y) : "l"(a), "l"(policy));
    asm("ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;"
        : "=f"(v.z), "=f"(v.w) : "l"(a + 2), "l"(policy));
  } else {
    v.x = load_g1(a, policy);
    v.y = load_g1(a + 1, policy);
    v.z = load_g1(a + 2, policy);
    v.w = load_g1(a + 3, policy);
  }
  return v;
}

// kVec: p and m share their alignment modulo 16, so a span's 16-byte slots
// are vectors of both; otherwise every element goes alone.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fused_sgd_kernel(const uint8_t* __restrict__ ok,
                 const float* __restrict__ lr_ptr, unsigned per_lane,
                 float* __restrict__ p, float* __restrict__ m, float mu,
                 int nesterov, int reset,
                 const __grid_constant__ Leaves leaves) {
  // The block's lane, leaf and span [lo, hi) of the leaf's row. Spans are
  // cut on p's 16-byte grid: only a segment's first span has a head of
  // elements before that grid, and only its last span a tail after it.
  // (ok, lr and per_lane lead the parameters, so the loads of ok[lane]
  // and lr wait on nothing but one read of them: every block has both in
  // flight before the first block's data loads crowd the memory system)
  const unsigned lane = blockIdx.x / per_lane;
  const long long b = blockIdx.x - lane * per_lane;
  const bool step = __ldg(ok + lane) != 0;
  const float lr = __ldg(lr_ptr);
  // the leaf: a select over every entry of the table, each read at a
  // fixed offset, so no read waits on another
  const float* g0 = leaves.ptr[0];
  long long size = leaves.size[0], off = 0, first = 0;
#pragma unroll
  for (int i = 1; i < kMaxLeaves; ++i) {
    if (i < leaves.count && b >= leaves.first[i]) {
      g0 = leaves.ptr[i];
      size = leaves.size[i];
      off = leaves.off[i];
      first = leaves.first[i];
    }
  }
  float* pk = p + lane * leaves.n + off;
  float* mk = m + lane * leaves.n + off;
  const float* gk = g0 + lane * size;
  long long h =
      ((16u - (reinterpret_cast<uintptr_t>(pk) & 15u)) & 15u) / 4;
  if (h > size) h = size;
  const long long i = b - first;
  long long lo = i == 0 ? 0 : h + i * leaves.span;
  long long hi = h + (i + 1) * leaves.span;
  if (lo > size) lo = size;
  if (hi > size) hi = size;
  const bool nest = nesterov != 0;
  const bool rs = reset != 0;
  const uint64_t policy = evict_first_policy();

  // items: elements before the first slot, 16-byte slots, a tail
  long long a = kVec ? (i == 0 ? h : lo) : hi;   // the first slot
  if (a > hi) a = hi;
  const long long slots = (hi - a) / 4;
  const long long tail = a + 4 * slots;
  const long long head = a - lo;
  const long long items = head + slots + (hi - tail);
  for (long long it = threadIdx.x; it < items; it += kThreads) {
    if (it >= head && it < head + slots) {
      const long long e = a + 4 * (it - head);
      float4* pq = reinterpret_cast<float4*>(pk + e);
      float4* mq = reinterpret_cast<float4*>(mk + e);
      if (step) {
        float4 pv = *pq;
        float4 mv = rs ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : *mq;
        const unsigned a16 =
            static_cast<unsigned>(reinterpret_cast<uintptr_t>(gk + e)) & 15u;
        const float4 gv = load_g4(gk + e, a16, policy);
        sgd_one(pv.x, gv.x, mv.x, lr, mu, nest, rs);
        sgd_one(pv.y, gv.y, mv.y, lr, mu, nest, rs);
        sgd_one(pv.z, gv.z, mv.z, lr, mu, nest, rs);
        sgd_one(pv.w, gv.w, mv.w, lr, mu, nest, rs);
        *pq = pv;
        *mq = mv;
      } else if (rs) {
        *mq = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    } else {
      const long long e = it < head ? lo + it : tail + (it - head - slots);
      if (step) {
        float pv = pk[e];
        float mv = rs ? 0.0f : mk[e];
        sgd_one(pv, load_g1(gk + e, policy), mv, lr, mu, nest, rs);
        pk[e] = pv;
        mk[e] = mv;
      } else if (rs) {
        mk[e] = 0.0f;
      }
    }
  }
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One element of the bfloat16 update, each operation rounded to bfloat16.
__device__ __forceinline__ void sgd_one_bf16(float& p, float g, float& m,
                                             float lr, float mu,
                                             bool nesterov, bool reset) {
  const float m_in = reset ? 0.0f : m;
  const float m_new = bf16_round(__fadd_rn(bf16_round(__fmul_rn(mu, m_in)),
                                           g));
  const float d =
      nesterov ? bf16_round(__fadd_rn(g, bf16_round(__fmul_rn(mu, m_new))))
               : m_new;
  p = bf16_round(__fsub_rn(p, bf16_round(__fmul_rn(lr, d))));
  m = m_new;
}

// Eight bfloat16 values of one 16-byte vector as floats, and back.
__device__ __forceinline__ void unpack8(uint4 v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// f holds values already rounded to bfloat16: their top halves are exact.
__device__ __forceinline__ uint4 pack8(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = (__float_as_uint(f[2 * j]) >> 16) |
           (__float_as_uint(f[2 * j + 1]) & 0xffff0000u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 load_g8(const __nv_bfloat16* a,
                                         uint64_t policy) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(a), "l"(policy));
  return v;
}

// kVec: p and m share their alignment modulo 16 (see fused_sgd_kernel).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fused_sgd_bf16_kernel(const uint8_t* __restrict__ ok,
                      const __nv_bfloat16* __restrict__ lr_ptr,
                      unsigned per_lane, __nv_bfloat16* __restrict__ p,
                      __nv_bfloat16* __restrict__ m, float mu, int nesterov,
                      int reset,
                      const __grid_constant__ LeafTable<__nv_bfloat16> leaves) {
  const unsigned lane = blockIdx.x / per_lane;
  const long long b = blockIdx.x - lane * per_lane;
  const bool step = __ldg(ok + lane) != 0;
  const float lr = __bfloat162float(lr_ptr[0]);
  const __nv_bfloat16* g0 = leaves.ptr[0];
  long long size = leaves.size[0], off = 0, first = 0;
#pragma unroll
  for (int i = 1; i < kMaxLeaves; ++i) {
    if (i < leaves.count && b >= leaves.first[i]) {
      g0 = leaves.ptr[i];
      size = leaves.size[i];
      off = leaves.off[i];
      first = leaves.first[i];
    }
  }
  __nv_bfloat16* pk = p + lane * leaves.n + off;
  __nv_bfloat16* mk = m + lane * leaves.n + off;
  const __nv_bfloat16* gk = g0 + lane * size;
  long long h =
      ((16u - (reinterpret_cast<uintptr_t>(pk) & 15u)) & 15u) / 2;
  if (h > size) h = size;
  const long long i = b - first;
  long long lo = i == 0 ? 0 : h + i * leaves.span;
  long long hi = h + (i + 1) * leaves.span;
  if (lo > size) lo = size;
  if (hi > size) hi = size;
  const bool nest = nesterov != 0;
  const bool rs = reset != 0;
  const uint64_t policy = evict_first_policy();

  // items: elements before the first slot, 16-byte slots of 8, a tail
  long long a = kVec ? (i == 0 ? h : lo) : hi;
  if (a > hi) a = hi;
  const long long slots = (hi - a) / 8;
  const long long tail = a + 8 * slots;
  const long long head = a - lo;
  const long long items = head + slots + (hi - tail);
  for (long long it = threadIdx.x; it < items; it += kThreads) {
    if (it >= head && it < head + slots) {
      const long long e = a + 8 * (it - head);
      uint4* pq = reinterpret_cast<uint4*>(pk + e);
      uint4* mq = reinterpret_cast<uint4*>(mk + e);
      if (step) {
        float pv[8], mv[8], gv[8];
        unpack8(*pq, pv);
        if (rs) {
#pragma unroll
          for (int j = 0; j < 8; ++j) mv[j] = 0.0f;
        } else {
          unpack8(*mq, mv);
        }
        if ((reinterpret_cast<uintptr_t>(gk + e) & 15u) == 0) {
          unpack8(load_g8(gk + e, policy), gv);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) gv[j] = __bfloat162float(gk[e + j]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sgd_one_bf16(pv[j], gv[j], mv[j], lr, mu, nest, rs);
        }
        *pq = pack8(pv);
        *mq = pack8(mv);
      } else if (rs) {
        *mq = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      const long long e = it < head ? lo + it : tail + (it - head - slots);
      if (step) {
        float pv = __bfloat162float(pk[e]);
        float mv = rs ? 0.0f : __bfloat162float(mk[e]);
        sgd_one_bf16(pv, __bfloat162float(gk[e]), mv, lr, mu, nest, rs);
        pk[e] = __float2bfloat16_rn(pv);
        mk[e] = __float2bfloat16_rn(mv);
      } else if (rs) {
        mk[e] = __float2bfloat16_rn(0.0f);
      }
    }
  }
}

}  // namespace

// C interface, bound with ctypes (kernels/fused_sgd/kernel.py). p and m are
// (lanes, n) contiguous float32; leaf k is a contiguous (lanes,
// leaf_sizes[k]) float32 tensor at leaf_ptrs[k], every size at least 1 and
// the sizes summing to n; ok is (lanes,) uint8; lr points at one float.
// span forces the elements a block updates, rounded up to a multiple of 4
// (0: kSpan). Launches on `stream` and returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for a leaf table or span the kernel
// does not take.
extern "C" int fused_sgd_lanes(float* p, float* m,
                               const float* const* leaf_ptrs,
                               const long long* leaf_sizes, int num_leaves,
                               const uint8_t* ok, const float* lr,
                               long long lanes, long long n, float momentum,
                               int nesterov, int reset, int span,
                               void* stream) {
  Leaves leaves;
  long long blocks;
  if (!make_table(leaves, blocks, leaf_ptrs, leaf_sizes, num_leaves, n, span,
                  4, kSpan)) {   // spans on p's grid
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (lanes <= 0) return 0;
  if (lanes > 0x7fffffffLL / blocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned per_lane = static_cast<unsigned>(blocks);
  const unsigned grid = static_cast<unsigned>(lanes * blocks);
  const bool vec =
      ((reinterpret_cast<uintptr_t>(p) ^ reinterpret_cast<uintptr_t>(m)) &
       15u) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    fused_sgd_kernel<true><<<grid, kThreads, 0, s>>>(
        ok, lr, per_lane, p, m, momentum, nesterov, reset, leaves);
  } else {
    fused_sgd_kernel<false><<<grid, kThreads, 0, s>>>(
        ok, lr, per_lane, p, m, momentum, nesterov, reset, leaves);
  }
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 case: p, m and the leaves are bfloat16, lr points at one
// bfloat16 value, momentum is mu already rounded to bfloat16 by the caller
// (kernels/fused_sgd/kernel.py); otherwise as fused_sgd_lanes, with span
// rounded up to a multiple of 8 (0: kSpanBf16).
extern "C" int fused_sgd_lanes_bf16(__nv_bfloat16* p, __nv_bfloat16* m,
                                    const __nv_bfloat16* const* leaf_ptrs,
                                    const long long* leaf_sizes,
                                    int num_leaves, const uint8_t* ok,
                                    const __nv_bfloat16* lr, long long lanes,
                                    long long n, float momentum, int nesterov,
                                    int reset, int span, void* stream) {
  LeafTable<__nv_bfloat16> leaves;
  long long blocks;
  if (!make_table(leaves, blocks, leaf_ptrs, leaf_sizes, num_leaves, n, span,
                  8, kSpanBf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (lanes <= 0) return 0;
  if (lanes > 0x7fffffffLL / blocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned per_lane = static_cast<unsigned>(blocks);
  const unsigned grid = static_cast<unsigned>(lanes * blocks);
  const bool vec =
      ((reinterpret_cast<uintptr_t>(p) ^ reinterpret_cast<uintptr_t>(m)) &
       15u) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    fused_sgd_bf16_kernel<true><<<grid, kThreads, 0, s>>>(
        ok, lr, per_lane, p, m, momentum, nesterov, reset, leaves);
  } else {
    fused_sgd_bf16_kernel<false><<<grid, kThreads, 0, s>>>(
        ok, lr, per_lane, p, m, momentum, nesterov, reset, leaves);
  }
  return static_cast<int>(cudaGetLastError());
}
