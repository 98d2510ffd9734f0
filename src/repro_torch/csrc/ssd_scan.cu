// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/ssd_scan/kernel.py::ssd_scan_bhcqp (body _ssd_kernel) together
// with the layout work of its wrapper ops.py::ssd_scan: this kernel reads
// x (B, L, H, P), dt (B, L, H) and B/C (B, L, G, N) in the model's layout,
// through strides (in the model x, B and C are column slices of the conv
// output, so their rows are not contiguous), and writes y (B, L, H, P)
// contiguous. There is no transpose to (B, H, NC, Q, P), no repeat of B/C
// across heads (head h reads group h / (H / G)) and no padded copy: a
// ragged last chunk is masked here, its missing steps acting as dt = 0
// (identity decay, no input), as the reference's padding does.
//
// For each (b, h) and chunk c of Q steps, with cs_i = sum_{r <= i} dt_r a
// within the chunk and S_{c-1} the (N, P) state before the chunk (zero
// before the first):
//   y_i     = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//             + exp(cs_i) C_i . S_{c-1}
//   S_c     = exp(cs_Q) S_{c-1} + dS_c,
//   dS_c    = sum_j (B_j exp(cs_Q - cs_j) dt_j) x_j^T
// x, B and C are float32 or bfloat16 (y takes x's type); dt and a are
// float32. Every score, decay and product, and the state, is float32: the
// Pallas kernel's contract (ROADMAP C4).
//
// Three passes, the chunk-parallel form of kernels/ssd_scan/ref.py (whose
// three plain functions they match one for one), enqueued in order on the
// caller's stream into float32 scratch that the caller allocates:
//   A. chunk states: one block per (b, h, chunk) writes dS_c into
//      states (B, NC, H, N, P) and exp(cs_Q) into decay (B, NC, H);
//   B. state passing: S_c = exp(cs_Q,c) S_{c-1} + dS_c over the chunks in
//      order, parallel over (b, h, N * P), a multiply then an add, each
//      rounded, as the plain loop does; S_{c-1} overwrites dS_c in place;
//   C. chunk outputs: one block per (b, h, chunk) reads S_{c-1} and writes
//      y for its Q steps.
// In every pass the running sum cs is taken by one thread in the plain
// version's order (a sequential scan, as torch.cumsum along a
// non-innermost dim runs): cs reaches tens within a chunk, so each decay
// exp(cs_i - cs_j) keeps only the digits that survive the subtraction, and
// the two versions then round them alike.
//
// Two bodies for passes A and C, chosen by the caller (kernels/ssd_scan/
// ops.py::kernel_route, an explicit function of dtype, Q, N and P; not a
// fallback: a route that the shape does not admit is refused):
//
// tensor cores (namespace tc): bfloat16 with Q = 64 or 128 and N, P
// multiples of 16. Operands are staged as bfloat16 tiles in shared memory
// in wgmma's 128 B swizzled layout (rows of 64 columns, 8-row atoms of
// 1 KB; the bfloat16 inputs by cp.async, zero-filled past the chunk and
// past N or P) and multiplied by wgmma m64n64k16 with float32
// accumulators. Inputs C, B, x are bfloat16 and exact. Each float32
// operand is split, v = hi + lo with hi = bf16(v) and lo = bf16(v - hi),
// and multiplied twice into one accumulator (a residual near 2^-17 of v):
// never rounded to bfloat16 alone.
//   A: two warpgroups, each 64 rows of N: dS = B^T (w x), w x split,
//      B^T and (w x) read MN-major (transposed) from shared memory.
//   C: Q / 64 warpgroups, each 64 rows of the chunk. y starts as C . S_{c-1}
//      (S split, MN-major), scaled by exp(cs_i) in float32 after the
//      product; then for each 64-key block at or below the diagonal the
//      scores C B^T (ss), scaled by exp(cs_i - cs_j) dt_j and masked above
//      the diagonal in registers, split into hi/lo A fragments (the
//      accumulator's layout is wgmma's A-fragment layout) and multiplied
//      by x from shared memory (rs).
// CUDA cores (namespace simt): every other shape, and float32. The chunk
// body of the first design, cut into the two passes: operands staged as
// float32 in shared memory, products on float32 FMAs from register tiles.
//
// Bound: at the path's shape (B=1, L=4096, H=80, G=1, P=64, N=128, Q=128,
// bfloat16) the function moves 87.3 MB (x and y dominate): 26 us at
// 3.35 TB/s; the causal products it needs are 18.9 GFLOP, 19 us at the
// H100's 989 TFLOP/s. The design moves more: the float32 states
// (84 MB) are written by A, read and written by B and read by C, about
// 420 MB in all before the 50 MB L2 absorbs part of it, and its tensor
// work (37.6 GFLOP with the splits and the full 64-key diagonal blocks)
// is 2.0x what the function needs. Those are the design's costs; the
// bound counts the function's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;

// the passes of ssd_scan_fwd's `passes` bit mask
constexpr int kStates = 1, kPassing = 2, kOutputs = 4;
// routes of passes A and C
constexpr int kCudaCores = 0, kTensorCores = 1;
// the exponent of a masked decay, as kernels/ssd_scan/ref.py's NEG_INF
constexpr float kNegInf = -1e30f;

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* bm;
  const void* cm;
  void* y;
  float* states;   // (B, NC, H, N, P): dS_c after A, S_{c-1} after B
  float* decay;    // (B, NC, H): exp(cs_Q)
  int L, H, G, P, N, Q, NC;
  int64_t sx_b, sx_l, sx_h;      // strides in elements; the last dim is 1
  int64_t sdt_b, sdt_l, sdt_h;
  int64_t sb_b, sb_l, sb_g;
  int64_t sc_b, sc_l, sc_g;
};

// The (b, h, chunk) of a block of pass A or C: blockIdx.x = chunk * H + h
// (the heads of one chunk are neighbours, so their reads of the group's B
// and C rows meet in L2), blockIdx.y = b.
struct Chunk {
  int b, h, c, grp, l0, valid;
  int64_t slab;   // index of (b, c, h) in (B, NC, H)
  __device__ explicit Chunk(const Args& args) {
    h = blockIdx.x % args.H;
    c = blockIdx.x / args.H;
    b = blockIdx.y;
    grp = h / (args.H / args.G);
    l0 = c * args.Q;
    valid = min(args.Q, args.L - l0);
    slab = (int64_t(b) * args.NC + c) * args.H + h;
  }
  template <typename T>
  __device__ const T* x(const Args& a) const {
    return static_cast<const T*>(a.x) + b * a.sx_b + int64_t(l0) * a.sx_l +
           h * a.sx_h;
  }
  template <typename T>
  __device__ const T* bmat(const Args& a) const {
    return static_cast<const T*>(a.bm) + b * a.sb_b + int64_t(l0) * a.sb_l +
           grp * a.sb_g;
  }
  template <typename T>
  __device__ const T* cmat(const Args& a) const {
    return static_cast<const T*>(a.cm) + b * a.sc_b + int64_t(l0) * a.sc_l +
           grp * a.sc_g;
  }
  template <typename T>
  __device__ T* y(const Args& a) const {
    return static_cast<T*>(a.y) + (int64_t(b) * a.L + l0) * a.H * a.P +
           int64_t(h) * a.P;
  }
};

// dts[t] = dt_t (0 past the chunk) and cs[t] = dt_t a for t < Q
__device__ __forceinline__ void stage_dt(const Args& args, const Chunk& ck,
                                         float* dts, float* cs, int t) {
  if (t < args.Q) {
    const float d = t < ck.valid
                        ? args.dt[ck.b * args.sdt_b +
                                  int64_t(ck.l0 + t) * args.sdt_l +
                                  ck.h * args.sdt_h]
                        : 0.0f;
    dts[t] = d;
    cs[t] = d * args.a[ck.h];
  }
}

// cs <- its running sum, added in the plain version's order (one thread;
// 32 loads in flight ahead of the chain of adds)
__device__ __forceinline__ void running_sum(float* cs, int Q) {
  float run = 0.0f;
  for (int i0 = 0; i0 < Q; i0 += 32) {
    float v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = i0 + k < Q ? cs[i0 + k] : 0.0f;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      run += v[k];
      v[k] = run;
    }
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (i0 + k < Q) cs[i0 + k] = v[k];
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// one element of T as float32 (a bfloat16 is the high half of a float32)
__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(p)) << 16);
}

// 16 bytes of T as float32: 4 floats or 8 bfloat16s
__device__ __forceinline__ void unpack(const uint4& v, float* out, float) {
  out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float* out,
                                       __nv_bfloat16) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    out[2 * e] = __uint_as_float(w[e] << 16);
    out[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

// ---------------------------------------------------------------------------
// CUDA-core body: float32 operands in shared memory, FMAs from registers

namespace simt {

constexpr int kThreads = 256;
constexpr int kRows = 32;       // score rows formed per pass
constexpr int kLoadUnroll = 8;  // global loads in flight a thread

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Shared-memory geometry of a block, in floats. Rows are padded to whole
// float4s (zeros past N, P or Q); B and C rows to an odd number of float4s,
// so the 8 rows of a quarter warp fall on distinct banks.
struct Geometry {
  int Qp, Np, Pp, ldb;
  __host__ __device__ Geometry(int Q, int N, int P)
      : Qp((Q + 3) & ~3), Np((N + 3) & ~3), Pp((P + 3) & ~3),
        ldb(4 * ((((N + 3) & ~3) / 4) | 1)) {}
  // pass A: x, B, and cs, dt, w
  __host__ __device__ int states_floats() const {
    return Qp * Pp + Qp * ldb + 3 * Qp;
  }
  // pass C: S, x, B, C, the scores of kRows rows, and cs, dt, exp(cs)
  __host__ __device__ int outputs_floats() const {
    return Np * Pp + Qp * Pp + 2 * Qp * ldb + kRows * Qp + 3 * Qp;
  }
};

__device__ __forceinline__ void zero(float* smem, int floats, int t) {
  for (int i = t; i < floats; i += kThreads) smem[i] = 0.0f;
}

// Copy `rows` x `cols` elements (row stride `stride`) into shared memory
// as float32 at row stride `ld` (a multiple of 4); rows past `valid` are
// zeros. Rows that are whole 16-byte vectors load as such.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src,
                                      int64_t stride, int rows, int valid,
                                      int cols, float* dst, int ld, int t) {
  constexpr int kVec = 16 / sizeof(T);
  if (cols % kVec == 0 && stride % kVec == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int cv = cols / kVec, total = rows * cv;
    for (int base = 0; base < total; base += kThreads * 4) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = base + u * kThreads + t;
        const int r = idx / cv, c = idx - r * cv;
        v[u] = idx < total && r < valid
                   ? *reinterpret_cast<const uint4*>(src + r * stride + c * kVec)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = base + u * kThreads + t;
        const int r = idx / cv, c = idx - r * cv;
        if (idx < total) {
          float f[kVec];
          unpack(v[u], f, T());
#pragma unroll
          for (int e = 0; e < kVec; e += 4)
            *reinterpret_cast<float4*>(dst + r * ld + c * kVec + e) =
                make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
        }
      }
    }
    return;
  }
  const int total = rows * cols;
  for (int base = 0; base < total; base += kThreads * kLoadUnroll) {
    float v[kLoadUnroll];
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int idx = base + u * kThreads + t;
      const int r = idx / cols, c = idx - r * cols;
      v[u] = idx < total && r < valid ? load_f32(src + r * stride + c) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int idx = base + u * kThreads + t;
      const int r = idx / cols, c = idx - r * cols;
      if (idx < total) dst[r * ld + c] = v[u];
    }
  }
}

// Scores of query rows r0 + warp + 8m (m < 4) against keys lane + 32n
// (n < NB): (C_i . B_j) exp(cs_i - cs_j) dt_j below the diagonal, else 0.
template <int NB>
__device__ __forceinline__ void score_rows(const float* Cs, const float* Bs,
                                           const float* cs, const float* dts,
                                           float* SC, int r0, int Q, int Np,
                                           int ldb, int ldsc, int warp,
                                           int lane) {
  float acc[4][NB];
  const float* crow[4];
  const float* brow[NB];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    crow[m] = Cs + min(r0 + warp + 8 * m, Q - 1) * ldb;
#pragma unroll
    for (int n = 0; n < NB; ++n) acc[m][n] = 0.0f;
  }
#pragma unroll
  for (int n = 0; n < NB; ++n) brow[n] = Bs + min(lane + 32 * n, Q - 1) * ldb;
  for (int k = 0; k < Np; k += 4) {
    float4 cv[4], bv[NB];
#pragma unroll
    for (int m = 0; m < 4; ++m) cv[m] = ld4(crow[m] + k);
#pragma unroll
    for (int n = 0; n < NB; ++n) bv[n] = ld4(brow[n] + k);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        acc[m][n] = fmaf(cv[m].x, bv[n].x, acc[m][n]);
        acc[m][n] = fmaf(cv[m].y, bv[n].y, acc[m][n]);
        acc[m][n] = fmaf(cv[m].z, bv[n].z, acc[m][n]);
        acc[m][n] = fmaf(cv[m].w, bv[n].w, acc[m][n]);
      }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = r0 + warp + 8 * m;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int j = lane + 32 * n;
      if (i < Q && j < Q)   // branch-free, as in tc::chunk_outputs
        SC[(warp + 8 * m) * ldsc + j] =
            acc[m][n] * expf(j <= i ? cs[i] - cs[j] : kNegInf) * dts[j];
    }
  }
}

// acc[r][c] += sum_k a_r[k] * b[k * ldb_ + c] over k < K (a multiple of 4):
// rows a_0, a_1 as float4 along k, b as float4 along the columns.
__device__ __forceinline__ void rows2_times(float (&acc)[2][4],
                                           const float* a0, const float* a1,
                                           const float* b, int ldb_, int K) {
  for (int k = 0; k < K; k += 4) {
    const float4 u = ld4(a0 + k), v = ld4(a1 + k);
    const float ua[4] = {u.x, u.y, u.z, u.w};
    const float va[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 bb = ld4(b + (k + e) * ldb_);
      acc[0][0] = fmaf(ua[e], bb.x, acc[0][0]);
      acc[0][1] = fmaf(ua[e], bb.y, acc[0][1]);
      acc[0][2] = fmaf(ua[e], bb.z, acc[0][2]);
      acc[0][3] = fmaf(ua[e], bb.w, acc[0][3]);
      acc[1][0] = fmaf(va[e], bb.x, acc[1][0]);
      acc[1][1] = fmaf(va[e], bb.y, acc[1][1]);
      acc[1][2] = fmaf(va[e], bb.z, acc[1][2]);
      acc[1][3] = fmaf(va[e], bb.w, acc[1][3]);
    }
  }
}

// Pass A: dS = (B * w)^T x, w_j = exp(cs_Q - cs_j) dt_j; thread (ty, tx) of
// the 16 x 16 layout owns rows 4 ty + 64 (m / 4) + m % 4 (m < 8) of N and
// columns 4 tx .. 4 tx + 3 of P.
template <typename T>
__global__ void __launch_bounds__(kThreads) chunk_states(Args args) {
  extern __shared__ __align__(16) float smem[];
  const int Q = args.Q, N = args.N, P = args.P;
  const Geometry geo(Q, N, P);
  const int Pp = geo.Pp, ldb = geo.ldb;
  float* Xs = smem;                 // Qp x Pp
  float* Bs = Xs + geo.Qp * Pp;     // Qp x ldb
  float* cs = Bs + geo.Qp * ldb;    // Qp
  float* dts = cs + geo.Qp;
  float* w = dts + geo.Qp;
  const Chunk ck(args);
  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;

  zero(smem, geo.states_floats(), t);
  __syncthreads();
  stage_dt(args, ck, dts, cs, t);
  stage(ck.x<T>(args), args.sx_l, Q, ck.valid, P, Xs, Pp, t);
  stage(ck.bmat<T>(args), args.sb_l, Q, ck.valid, N, Bs, ldb, t);
  __syncthreads();
  if (t == 0) running_sum(cs, Q);
  __syncthreads();
  const float cs_last = cs[Q - 1];
  if (t < Q) w[t] = expf(cs_last - cs[t]) * dts[t];
  if (t == 0) args.decay[ck.slab] = expf(cs_last);
  __syncthreads();
  for (int idx = t; idx < Q * N; idx += kThreads) {
    const int j = idx / N, n = idx - j * N;
    Bs[j * ldb + n] *= w[j];
  }
  __syncthreads();

  float acc[8][4] = {};
  const int pc = min(4 * tx, Pp - 4);
  const int nb0 = min(4 * ty, geo.Np - 4), nb1 = min(64 + 4 * ty, geo.Np - 4);
  for (int j = 0; j < Q; ++j) {
    const float4 b0 = ld4(Bs + j * ldb + nb0);
    const float4 b1 = ld4(Bs + j * ldb + nb1);
    const float4 xv = ld4(Xs + j * Pp + pc);
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(bv[m], xa[c], acc[m][c]);
  }
  float* out = args.states + ck.slab * N * P;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int n = 4 * ty + 64 * (m / 4) + m % 4;
    if (n >= N) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = 4 * tx + c;
      if (p < P) out[n * P + p] = acc[m][c];
    }
  }
}

// Pass C: y of the chunk from its x, B, C and S_{c-1}. The Q x Q scores
// are formed 32 query rows at a time and consumed at once by the y product
// of the same rows; column tiles wholly above the diagonal are skipped.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) chunk_outputs(Args args) {
  extern __shared__ __align__(16) float smem[];
  const int Q = args.Q, N = args.N, P = args.P, H = args.H;
  const Geometry geo(Q, N, P);
  const int Np = geo.Np, Pp = geo.Pp, ldb = geo.ldb, ldsc = geo.Qp;
  float* Ss = smem;                 // Np x Pp state before the chunk
  float* Xs = Ss + Np * Pp;         // Qp x Pp
  float* Bs = Xs + geo.Qp * Pp;     // Qp x ldb
  float* Cs = Bs + geo.Qp * ldb;    // Qp x ldb
  float* SC = Cs + geo.Qp * ldb;    // kRows x ldsc
  float* cs = SC + kRows * ldsc;    // Qp
  float* dts = cs + geo.Qp;
  float* ecs = dts + geo.Qp;
  const Chunk ck(args);
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int tx = t & 15, ty = t >> 4;  // 16 x 16 threads: y
  T* yb = ck.y<T>(args);

  // zeros everywhere: the padding past N, P and Q is never written
  zero(smem, geo.outputs_floats(), t);
  __syncthreads();
  stage_dt(args, ck, dts, cs, t);
  stage(args.states + ck.slab * N * P, P, N, N, P, Ss, Pp, t);
  stage(ck.x<T>(args), args.sx_l, Q, ck.valid, P, Xs, Pp, t);
  stage(ck.bmat<T>(args), args.sb_l, Q, ck.valid, N, Bs, ldb, t);
  stage(ck.cmat<T>(args), args.sc_l, Q, ck.valid, N, Cs, ldb, t);
  __syncthreads();
  if (t == 0) running_sum(cs, Q);
  __syncthreads();
  if (t < Q) ecs[t] = expf(cs[t]);
  __syncthreads();

  const int pc = min(4 * tx, Pp - 4);  // this thread's 4 columns of P
  for (int r0 = 0; r0 < Q; r0 += kRows) {
    // keys j < jmax can reach the rows r0 .. r0 + kRows - 1
    const int jmax = min(Q, r0 + kRows);
    switch ((jmax + 31) / 32) {
      case 1: score_rows<1>(Cs, Bs, cs, dts, SC, r0, Q, Np, ldb, ldsc, warp, lane); break;
      case 2: score_rows<2>(Cs, Bs, cs, dts, SC, r0, Q, Np, ldb, ldsc, warp, lane); break;
      case 3: score_rows<3>(Cs, Bs, cs, dts, SC, r0, Q, Np, ldb, ldsc, warp, lane); break;
      default: score_rows<4>(Cs, Bs, cs, dts, SC, r0, Q, Np, ldb, ldsc, warp, lane); break;
    }
    __syncthreads();
    // y of rows r0 + ty and r0 + ty + 16, columns pc .. pc + 3: the
    // scores times x, plus exp(cs_i) times C_i . S_{c-1}
    float yi[2][4] = {}, yo[2][4] = {};
    rows2_times(yi, SC + ty * ldsc, SC + (ty + 16) * ldsc, Xs + pc, Pp,
                (jmax + 3) & ~3);
    rows2_times(yo, Cs + min(r0 + ty, Q - 1) * ldb,
                Cs + min(r0 + ty + 16, Q - 1) * ldb, Ss + pc, Pp, Np);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + ty + 16 * r;
      if (i >= ck.valid) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = 4 * tx + c;
        if (p < P)
          yb[int64_t(i) * H * P + p] =
              from_f32<T>(yi[r][c] + ecs[i] * yo[r][c]);
      }
    }
    __syncthreads();             // the next rows overwrite the scores
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// tensor-core body: bfloat16 tiles in shared memory, wgmma

namespace tc {

// A tile is R rows by 64 * boxes bfloat16 columns, stored box by box (64
// columns each); inside a box row r is 128 B whose 16-byte units are
// swizzled by r % 8, as wgmma reads a 128 B swizzled operand. Boxes and
// tiles start on 1 KB (one 8-row atom).
__device__ __forceinline__ uint32_t tile_offset(int rows, int r, int unit) {
  return (unit >> 3) * rows * 128 + r * 128 + (((unit & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// cp.async writes are complete, and this thread's shared-memory writes are
// visible to wgmma (the async proxy); a barrier must follow
__device__ __forceinline__ void staged_for_wgmma() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  uint32_t u;
  memcpy(&u, &x, sizeof(u));
  return u;
}

// Copy `rows` rows of bfloat16 (row stride `stride`, `cols` columns) into a
// tile of `boxes` boxes at `tile`; units past `valid` rows or `cols`
// columns are zeros. 16-byte cp.async where rows are whole aligned units
// (they are in the model), element by element otherwise.
template <int NT>
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* src,
                                           int64_t stride, int rows,
                                           int valid, int cols, int boxes,
                                           uint8_t* base, uint32_t tile,
                                           int t) {
  const int per_row = 8 * boxes, total = rows * per_row;
  const bool vec = cols % 8 == 0 && stride % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int u = t; u < total; u += NT) {
    const int r = u / per_row, k = u - r * per_row;
    const uint32_t off = tile_offset(rows, r, k);
    const bool live = r < valid && 8 * k < cols;
    if (vec) {
      cp_async16(smem_u32(base) + tile + off,
                 live ? src + r * stride + 8 * k : src, live ? 16u : 0u);
    } else {
      uint16_t e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        e[i] = live && 8 * k + i < cols
                   ? *reinterpret_cast<const uint16_t*>(src + r * stride +
                                                        8 * k + i)
                   : uint16_t(0);
      uint4 v;
      memcpy(&v, e, sizeof(v));
      *reinterpret_cast<uint4*>(base + tile + off) = v;
    }
  }
}

// 8 float32 values as bfloat16 hi and lo parts (v = hi + lo + O(2^-17 v))
__device__ __forceinline__ void split8(const float (&v)[8], uint4& hi,
                                       uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    const float2 f = __bfloat1622float2(b);
    h[i] = bf16x2_bits(b);
    l[i] = bf16x2_bits(
        __floats2bfloat162_rn(v[2 * i] - f.x, v[2 * i + 1] - f.y));
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// wgmma shared-memory descriptor of a 128 B swizzled operand: start
// address, leading and stride byte offsets (16 B units), layout type 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// K-major operand: 64 rows from `addr` (the 16 columns of a k step; the
// next 8 rows lie one 1 KB atom on). LBO is unused when swizzled.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}

// MN-major operand: 16 rows of K from `addr`, 64 columns of M or N along
// the row (the next 8 rows of K one atom on; one box, so LBO is unused).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return smem_desc(addr, 1024, 1024);
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

// d (64 x 64, float32 fragment) += A (64 x 16) B (16 x 64). The fragment
// of thread t of the warpgroup holds, for each 8 columns j, rows
// 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1):
// d[4 j + 2 (row half) + (column parity)]. _ss: A and B in shared memory,
// TA / TB = 1 where the operand is MN-major (transposed); _rs: A in
// registers (that same layout, bfloat16 pairs), B MN-major.
#define WGMMA_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WGMMA_D16(i) \
  WGMMA_D4(i), WGMMA_D4(i + 4), WGMMA_D4(i + 8), WGMMA_D4(i + 12)
#define WGMMA_P32                                                           \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"

// Both always add to d (scale-d = 1): the callers zero it first.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WGMMA_P32
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : WGMMA_D16(0), WGMMA_D16(16)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WGMMA_P32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_D16(0), WGMMA_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef WGMMA_P32
#undef WGMMA_D16
#undef WGMMA_D4

// Shared-memory layout of a block, in bytes from the dynamic window's
// base, which is 1 KB aligned (checked): no slack, so that two blocks of
// pass C (113 KB each at N = Q = 128) share an SM.
struct Layout {
  int boxes_n;                    // 64-column boxes of B and C (N <= 128)
  uint32_t b, c, x, xlo, s, slo, f32, bytes;
  __host__ __device__ Layout(int Q, int N, bool outputs) {
    boxes_n = (N + 63) / 64;
    b = 0;
    c = b + Q * 128 * boxes_n;                    // C (pass C only)
    x = c + (outputs ? Q * 128 * boxes_n : 0);    // x, or (w x)_hi in A
    xlo = x + Q * 128;                            // (w x)_lo (pass A only)
    s = xlo + (outputs ? 0 : Q * 128);            // S_{c-1} hi (pass C)
    slo = s + (outputs ? 64 * boxes_n * 128 : 0); // S_{c-1} lo (pass C)
    f32 = slo + (outputs ? 64 * boxes_n * 128 : 0);  // cs, dt (and w in A)
    bytes = f32 + (outputs ? 2 : 3) * Q * 4;
  }
};

__device__ __forceinline__ uint8_t* aligned_base(uint8_t* smem_raw) {
  if (smem_u32(smem_raw) & 1023u) __trap();
  return smem_raw;
}

// Pass A: two warpgroups, warpgroup g owns rows 64 g .. 64 g + 63 of N:
// dS = B^T (w x), both operands MN-major; (w x) split hi + lo.
template <int Q>
__global__ void __launch_bounds__(256) chunk_states(Args args) {
  extern __shared__ uint8_t smem_raw[];
  const int N = args.N, P = args.P;
  const Layout lay(Q, N, false);
  uint8_t* base = aligned_base(smem_raw);
  const uint32_t sbase = smem_u32(base);
  float* cs = reinterpret_cast<float*>(base + lay.f32);
  float* dts = cs + Q;
  float* w = dts + Q;
  const Chunk ck(args);
  const int t = threadIdx.x;

  stage_dt(args, ck, dts, cs, t);
  stage_tile<256>(ck.bmat<__nv_bfloat16>(args), args.sb_l, Q, ck.valid, N,
                  lay.boxes_n, base, lay.b, t);
  // this thread's units of x (8 columns of one row), in flight while the
  // running sum is taken: Q * 8 units, at most 4 a thread
  const __nv_bfloat16* xs = ck.x<__nv_bfloat16>(args);
  const bool xvec = args.sx_l % 8 == 0 &&
                    (reinterpret_cast<uintptr_t>(xs) & 15) == 0;
  uint4 xv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = t + 256 * i, r = u >> 3, k = u & 7;
    xv[i] = make_uint4(0u, 0u, 0u, 0u);
    if (r < ck.valid && 8 * k < P) {
      if (xvec) {
        xv[i] = *reinterpret_cast<const uint4*>(xs + r * args.sx_l + 8 * k);
      } else {
        uint16_t e[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          e[q] = *reinterpret_cast<const uint16_t*>(xs + r * args.sx_l +
                                                    8 * k + q);
        memcpy(&xv[i], e, sizeof(uint4));
      }
    }
  }
  __syncthreads();
  if (t == 0) running_sum(cs, Q);
  __syncthreads();
  const float cs_last = cs[Q - 1];
  if (t < Q) w[t] = expf(cs_last - cs[t]) * dts[t];
  if (t == 0) args.decay[ck.slab] = expf(cs_last);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = t + 256 * i, r = u >> 3, k = u & 7;
    if (r >= Q) continue;
    float f[8];
    unpack(xv[i], f, __nv_bfloat16());
#pragma unroll
    for (int q = 0; q < 8; ++q) f[q] *= w[r];
    uint4 hi, lo;
    split8(f, hi, lo);
    const uint32_t off = tile_offset(Q, r, k);
    *reinterpret_cast<uint4*>(base + lay.x + off) = hi;
    *reinterpret_cast<uint4*>(base + lay.xlo + off) = lo;
  }
  staged_for_wgmma();
  __syncthreads();

  const int wg = t / 128, lt = t % 128;
  if (64 * wg >= N) return;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  const uint32_t bt = sbase + lay.b + wg * Q * 128;   // box wg: n in [64 wg, +64)
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Q / 16; ++kk) {
    const uint64_t da = desc_mn_major(bt + kk * 2048);
    wgmma_ss<1, 1>(acc, da, desc_mn_major(sbase + lay.x + kk * 2048));
    wgmma_ss<1, 1>(acc, da, desc_mn_major(sbase + lay.xlo + kk * 2048));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);

  float* out = args.states + ck.slab * N * P;
  const int n0 = 64 * wg + 16 * (lt / 32) + (lt % 32) / 4, p0 = 2 * (lt % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = n0 + 8 * half;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = 8 * j + p0;
      if (p < P)
        *reinterpret_cast<float2*>(out + n * P + p) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

// Pass C: Q / 64 warpgroups, warpgroup g owns rows 64 g .. 64 g + 63 of the
// chunk and the 64-key blocks 0 .. g of its scores. N is padded with zeros
// to NB boxes of 64, the products' depth.
template <int Q, int NB>
__global__ void __launch_bounds__(2 * Q, 256 / Q) chunk_outputs(Args args) {
  constexpr int NT = 2 * Q;
  constexpr int kSteps = 4 * NB;        // 16-deep k steps over N
  extern __shared__ uint8_t smem_raw[];
  const int N = args.N, P = args.P, H = args.H;
  const Layout lay(Q, N, true);
  uint8_t* base = aligned_base(smem_raw);
  const uint32_t sbase = smem_u32(base);
  float* cs = reinterpret_cast<float*>(base + lay.f32);
  float* dts = cs + Q;
  const Chunk ck(args);
  const int t = threadIdx.x;

  stage_dt(args, ck, dts, cs, t);
  stage_tile<NT>(ck.cmat<__nv_bfloat16>(args), args.sc_l, Q, ck.valid, N,
                 lay.boxes_n, base, lay.c, t);
  stage_tile<NT>(ck.bmat<__nv_bfloat16>(args), args.sb_l, Q, ck.valid, N,
                 lay.boxes_n, base, lay.b, t);
  stage_tile<NT>(ck.x<__nv_bfloat16>(args), args.sx_l, Q, ck.valid, P, 1,
                 base, lay.x, t);
  // S_{c-1} (N x P float32, rows of P) as hi and lo tiles of 64 NB rows,
  // zeros past N and P: 64 NB * 8 units of 8 floats, loaded while the
  // running sum is taken
  constexpr int kUnits = 64 * NB * 8 / NT;
  const float* sp = args.states + ck.slab * N * P;
  float4 sv[kUnits][2];
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const int u = t + NT * i, n = u >> 3, k = u & 7;
    const bool live = n < N && 8 * k < P;
    const float4* src = reinterpret_cast<const float4*>(sp + n * P + 8 * k);
    sv[i][0] = live ? src[0] : make_float4(0.f, 0.f, 0.f, 0.f);
    sv[i][1] = live ? src[1] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  if (t == 0) running_sum(cs, Q);
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const int u = t + NT * i, n = u >> 3, k = u & 7;
    const float f[8] = {sv[i][0].x, sv[i][0].y, sv[i][0].z, sv[i][0].w,
                        sv[i][1].x, sv[i][1].y, sv[i][1].z, sv[i][1].w};
    uint4 hi, lo;
    split8(f, hi, lo);
    const uint32_t off = tile_offset(64 * NB, n, k);
    *reinterpret_cast<uint4*>(base + lay.s + off) = hi;
    *reinterpret_cast<uint4*>(base + lay.slo + off) = lo;
  }
  staged_for_wgmma();
  __syncthreads();

  const int wg = t / 128, lt = t % 128;
  const int r_lo = 64 * wg;
  const int row0 = r_lo + 16 * (lt / 32) + (lt % 32) / 4;   // and row0 + 8
  const int col0 = 2 * (lt % 4);
  // the k step kk of this warpgroup's 64 rows of C (K-major)
  auto c_desc = [&](int kk) {
    return desc_k_major(sbase + lay.c + (kk / 4) * Q * 128 + r_lo * 128 +
                        (kk % 4) * 32);
  };

  auto scores = [&](float (&s)[32], int jb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      wgmma_ss<0, 0>(s, c_desc(kk),
                     desc_k_major(sbase + lay.b + (kk / 4) * Q * 128 +
                                  64 * jb * 128 + (kk % 4) * 32));
  };

  // y = exp(cs_i) (C_i . S_{c-1}), S as hi + lo, and the first scores
  // block, in one group
  float y[32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) y[i] = 0.0f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    wgmma_ss<0, 1>(y, c_desc(kk), desc_mn_major(sbase + lay.s + kk * 2048));
    wgmma_ss<0, 1>(y, c_desc(kk), desc_mn_major(sbase + lay.slo + kk * 2048));
  }
  scores(s, 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(y);
  fence_regs(s);
  const float cs_r[2] = {cs[row0], cs[row0 + 8]};
  const float e_r[2] = {expf(cs_r[0]), expf(cs_r[1])};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[4 * j + e] *= e_r[e >> 1];

  // + the scores of each 64-key block at or below the diagonal times x
  for (int jb = 0; jb <= wg; ++jb) {
    if (jb > 0) {
      scores(s, jb);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e >> 1);
        const int col = 64 * jb + 8 * j + col0 + (e & 1);
        // the exponent, not the product, is selected: every element then
        // runs the same code with no branch (above the diagonal as the
        // plain version masks it, exp(-1e30) = 0)
        const float arg = col <= row ? cs_r[e >> 1] - cs[col] : kNegInf;
        s[4 * j + e] = s[4 * j + e] * expf(arg) * dts[col];
      }
    // the score fragment's 16-key step kk is the A fragment of step kk
    uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float u = s[8 * kk + 2 * c], v = s[8 * kk + 2 * c + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(u, v);
        const float2 hf = __bfloat1622float2(hi);
        a_hi[kk][c] = bf16x2_bits(hi);
        a_lo[kk][c] = bf16x2_bits(__floats2bfloat162_rn(u - hf.x, v - hf.y));
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db =
          desc_mn_major(sbase + lay.x + (4 * jb + kk) * 2048);
      wgmma_rs(y, a_hi[kk], db);
      wgmma_rs(y, a_lo[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(y);
    fence_regs(a_hi);
    fence_regs(a_lo);
  }

  __nv_bfloat16* yb = ck.y<__nv_bfloat16>(args);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = row0 + 8 * half;
    if (i >= ck.valid) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = 8 * j + col0;
      if (p < P)
        *reinterpret_cast<__nv_bfloat162*>(yb + int64_t(i) * H * P + p) =
            __floats2bfloat162_rn(y[4 * j + 2 * half],
                                  y[4 * j + 2 * half + 1]);
    }
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Pass B: S_{c-1} over the chunks in order, V consecutive elements of one
// (b, h)'s N x P state a thread, kAhead chunks' loads in flight.

constexpr int kPassThreads = 256;
constexpr int kAhead = 8;

template <int V>
__global__ void __launch_bounds__(kPassThreads)
state_passing(float* __restrict__ states, const float* __restrict__ decay,
              int NC, int H, int NP) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int e = (blockIdx.x * kPassThreads + threadIdx.x) * V;
  if (e >= NP) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t step = int64_t(H) * NP;             // one chunk on
  float* s = states + (int64_t(b) * NC * H + h) * NP + e;
  const float* d = decay + int64_t(b) * NC * H + h;
  float run[V] = {};
  for (int c0 = 0; c0 < NC; c0 += kAhead) {
    Vec ds[kAhead];
    float dc[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (c0 + u < NC) {
        ds[u] = *reinterpret_cast<const Vec*>(s + (c0 + u) * step);
        dc[u] = d[int64_t(c0 + u) * H];
      }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (c0 + u >= NC) break;
      float add[V], before[V];
      memcpy(add, &ds[u], sizeof(add));
#pragma unroll
      for (int i = 0; i < V; ++i) {
        before[i] = run[i];
        run[i] = __fadd_rn(__fmul_rn(dc[u], run[i]), add[i]);
      }
      Vec out;
      memcpy(&out, before, sizeof(out));
      *reinterpret_cast<Vec*>(s + (c0 + u) * step) = out;
    }
  }
}

// ---------------------------------------------------------------------------
// launches

// Lets `fn` take `bytes` of dynamic shared memory, with the SM's whole
// carveout as shared memory so that as many blocks as fit share an SM.
int set_smem(const void* fn, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(err);
}

// Launches kernel `fn` over the (chunk, head) x batch grid with `smem`
// bytes of dynamic shared memory.
int launch_chunks(void (*fn)(Args), const Args& args, int B, int threads,
                  int smem, cudaStream_t st) {
  if (int err = set_smem(reinterpret_cast<const void*>(fn), smem)) return err;
  fn<<<dim3(args.NC * args.H, B), threads, smem, st>>>(args);
  return 0;
}

template <typename T>
int launch_simt(const Args& args, int B, int passes, cudaStream_t st) {
  const simt::Geometry geo(args.Q, args.N, args.P);
  constexpr int f = sizeof(float);
  return passes == kStates
             ? launch_chunks(simt::chunk_states<T>, args, B, simt::kThreads,
                             geo.states_floats() * f, st)
             : launch_chunks(simt::chunk_outputs<T>, args, B, simt::kThreads,
                             geo.outputs_floats() * f, st);
}

int launch_tc(const Args& args, int B, int passes, cudaStream_t st) {
  const int smem = static_cast<int>(
      tc::Layout(args.Q, args.N, passes == kOutputs).bytes);
  const bool q64 = args.Q == 64, nb1 = args.N <= 64;
  if (passes == kStates)
    return launch_chunks(q64 ? tc::chunk_states<64> : tc::chunk_states<128>,
                         args, B, 256, smem, st);
  auto* fn = q64 ? (nb1 ? tc::chunk_outputs<64, 1> : tc::chunk_outputs<64, 2>)
                 : (nb1 ? tc::chunk_outputs<128, 1> : tc::chunk_outputs<128, 2>);
  return launch_chunks(fn, args, B, 2 * args.Q, smem, st);
}

// Pass A or C (`pass` is kStates or kOutputs) on `route`.
int launch_pass(const Args& args, int B, int dtype, int route, int pass,
                cudaStream_t st) {
  if (route == kTensorCores) return launch_tc(args, B, pass, st);
  return dtype == 0 ? launch_simt<float>(args, B, pass, st)
                    : launch_simt<__nv_bfloat16>(args, B, pass, st);
}

int launch_passing(const Args& args, int B, cudaStream_t st) {
  const int NP = args.N * args.P, V = NP % 4 == 0 ? 4 : 1;
  const dim3 grid((NP / V + kPassThreads - 1) / kPassThreads, args.H, B);
  if (V == 4)
    state_passing<4><<<grid, kPassThreads, 0, st>>>(args.states, args.decay,
                                                    args.NC, args.H, NP);
  else
    state_passing<1><<<grid, kPassThreads, 0, st>>>(args.states, args.decay,
                                                    args.NC, args.H, NP);
  return 0;
}

// The asked passes of one scan, in order, on `st`.
int launch(const Args& args, int B, int dtype, int route, int passes,
           cudaStream_t st) {
  int err = 0;
  if (passes & kStates) err = launch_pass(args, B, dtype, route, kStates, st);
  if (!err && (passes & kPassing)) err = launch_passing(args, B, st);
  if (!err && (passes & kOutputs))
    err = launch_pass(args, B, dtype, route, kOutputs, st);
  return err ? err : static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes (kernels/ssd_scan/kernel.py).
// x (B, L, H, P), b and c (B, L, G, N) of `dtype` (0 = float32,
// 1 = bfloat16), dt (B, L, H) float32, a (H,) float32 contiguous, y
// (B, L, H, P) of `dtype` contiguous; `states` (B, NC, H, N, P) and `decay`
// (B, NC, H) float32 contiguous scratch, NC = ceil(L / Q). `strides` holds
// 12 element strides: x's (b, l, h), dt's (b, l, h), b's (b, l, g) and c's
// (b, l, g); the last dims of x, b and c are contiguous. `route` 0 runs
// passes A and C on CUDA cores, 1 on tensor cores (bfloat16, Q = 64 or
// 128, N and P multiples of 16). `passes` is a bit mask: 1 = chunk states
// (writes states and decay), 2 = state passing (states in place), 4 =
// chunk outputs (reads states as S_{c-1}, writes y); a scan is 7. Takes
// 1 <= Q <= 128, 1 <= N <= 128, 1 <= P <= 64, H a multiple of G,
// B <= 65535. Launches on `stream`; returns cudaGetLastError() (0 =
// launched), a CUDA error of an attribute call, or -1 for a shape, type or
// route it does not take.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* a,
                            const void* b, const void* c, void* y,
                            float* states, float* decay, int dtype,
                            int route, int passes, int B, int L, int H,
                            int G, int P, int N, int Q,
                            const int64_t* strides, void* stream) {
  if (B <= 0 || B > 65535 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 ||
      P <= 0 || P > kMaxP || N <= 0 || N > kMaxN || Q <= 0 || Q > kMaxQ ||
      (dtype != 0 && dtype != 1) || passes <= 0 || passes > 7)
    return -1;
  const int NC = (L + Q - 1) / Q;
  if (int64_t(NC) * H > 2147483647 || H > 65535) return -1;
  if (route == kTensorCores) {
    if (dtype != 1 || (Q != 64 && Q != 128) || N % 16 != 0 || P % 16 != 0)
      return -1;
  } else if (route != kCudaCores) {
    return -1;
  }
  Args args{x, dt, a, b, c, y, states, decay, L, H, G, P, N, Q, NC,
            strides[0], strides[1], strides[2], strides[3], strides[4],
            strides[5], strides[6], strides[7], strides[8], strides[9],
            strides[10], strides[11]};
  return launch(args, B, dtype, route, passes,
                static_cast<cudaStream_t>(stream));
}
