// Lane-stacked fused momentum-SGD update for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/fused_sgd/kernel.py::fused_sgd_flat (body _fused_sgd_kernel),
// together with what surrounds it on the FL main path: the
// (1 - reset) * m momentum reset of core/local.py::_run_hops, the
// ravel_pytree -> padded flat kernel -> where(ok) select of
// masked_momentum_update, and the pad-to-tile wrapper of ops.py.
//
// One launch updates the whole (C, P) lane stack of one SGD step, in place:
//   m_in = reset ? 0 : m
//   m'   = mu * m_in + g
//   d    = nesterov ? g + mu * m' : m'
//   p'   = p - lr * d
// Lanes with ok[c] == 0 keep p and take m = m_in (so a visit start still
// zeroes their momentum, as in the reference scan). lr is read from device
// memory (a (1,) float tensor), so a scheduled lr needs no host round trip.
//
// Bound: memory. Per element the update reads p, g, m (12 B) and writes p, m
// (8 B): 20 B for 4 flops, far below the H100's ~20 flop/B balance point, so
// the least time is 20 * C * P bytes over the card's memory rate (C=5,
// P=199,210: 19.9 MB -> about 6 us at 3.35 TB/s). The design does what a
// memory-bound pass can: one read and one write of each buffer, 16-byte
// vector accesses where the three rows share an alignment, no scratch, and
// lanes that take no step (ok == 0) skip their rows entirely.
//
// Every multiply and add is an explicitly rounded intrinsic, so nvcc cannot
// contract p - lr * d into an FMA: the kernel matches its plain PyTorch
// version (kernels/fused_sgd/ref.py) bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void sgd_one(float& p, float g, float& m, float lr,
                                        float mu, bool nesterov, bool reset) {
  const float m_in = reset ? 0.0f : m;
  const float m_new = __fadd_rn(__fmul_rn(mu, m_in), g);
  const float d = nesterov ? __fadd_rn(g, __fmul_rn(mu, m_new)) : m_new;
  p = __fsub_rn(p, __fmul_rn(lr, d));
  m = m_new;
}

// grid: (blocks per lane, C). Block (x, c) strides over lane c's row.
__global__ void __launch_bounds__(kThreads)
fused_sgd_lanes_kernel(float* __restrict__ p, const float* __restrict__ g,
                       float* __restrict__ m, const uint8_t* __restrict__ ok,
                       const float* __restrict__ lr_ptr, int64_t n, float mu,
                       int nesterov, int reset) {
  const int64_t lane = blockIdx.y;
  float* pl = p + lane * n;
  const float* gl = g + lane * n;
  float* ml = m + lane * n;
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;

  if (ok[lane] == 0) {
    if (reset) {
      for (int64_t i = tid; i < n; i += stride) ml[i] = 0.0f;
    }
    return;
  }
  const float lr = *lr_ptr;
  const bool nest = nesterov != 0;
  const bool rs = reset != 0;

  // 16-byte vector path only when p, g and m rows share their alignment
  // modulo 16; a scalar head brings them to the boundary.
  const uintptr_t ap = reinterpret_cast<uintptr_t>(pl);
  const bool same = ((ap ^ reinterpret_cast<uintptr_t>(gl)) & 15u) == 0 &&
                    ((ap ^ reinterpret_cast<uintptr_t>(ml)) & 15u) == 0;
  int64_t head = same ? int64_t(((16u - (ap & 15u)) & 15u) / 4u) : n;
  if (head > n) head = n;

  for (int64_t i = tid; i < head; i += stride) {
    float pv = pl[i], mv = ml[i];
    sgd_one(pv, gl[i], mv, lr, mu, nest, rs);
    pl[i] = pv;
    ml[i] = mv;
  }
  const int64_t nvec = (n - head) / 4;
  float4* p4 = reinterpret_cast<float4*>(pl + head);
  const float4* g4 = reinterpret_cast<const float4*>(gl + head);
  float4* m4 = reinterpret_cast<float4*>(ml + head);
  for (int64_t i = tid; i < nvec; i += stride) {
    float4 pv = p4[i];
    const float4 gv = g4[i];
    float4 mv = m4[i];
    sgd_one(pv.x, gv.x, mv.x, lr, mu, nest, rs);
    sgd_one(pv.y, gv.y, mv.y, lr, mu, nest, rs);
    sgd_one(pv.z, gv.z, mv.z, lr, mu, nest, rs);
    sgd_one(pv.w, gv.w, mv.w, lr, mu, nest, rs);
    p4[i] = pv;
    m4[i] = mv;
  }
  for (int64_t i = head + nvec * 4 + tid; i < n; i += stride) {
    float pv = pl[i], mv = ml[i];
    sgd_one(pv, gl[i], mv, lr, mu, nest, rs);
    pl[i] = pv;
    ml[i] = mv;
  }
}

}  // namespace

// C interface, bound with ctypes (kernels/fused_sgd/kernel.py). p, g, m are
// (lanes, n) contiguous float32; ok is (lanes,) uint8; lr points at one
// float. Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int fused_sgd_lanes(float* p, const float* g, float* m,
                               const uint8_t* ok, const float* lr,
                               long long lanes, long long n, float momentum,
                               int nesterov, int reset, void* stream) {
  if (lanes <= 0 || n <= 0) return 0;
  const long long vec = (n + 3) / 4;
  long long blocks = (vec + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(lanes));
  fused_sgd_lanes_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      p, g, m, ok, lr, n, momentum, nesterov, reset);
  return static_cast<int>(cudaGetLastError());
}
