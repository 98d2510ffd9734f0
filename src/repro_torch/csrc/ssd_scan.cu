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
// For each (b, h), chunk by chunk of Q steps, with the (N, P) state S
// carried from one chunk to the next (zero before the first):
//   cs_i = sum_{r <= i} dt_r a                       (within the chunk)
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//          + exp(cs_i) C_i . S
//   S   <- exp(cs_Q) S + sum_j (B_j exp(cs_Q - cs_j) dt_j) x_j^T
// x, B and C are float32 or bfloat16 (y takes x's type); dt and a are
// float32. Every score, decay and product, and the state, is float32: the
// Pallas kernel's contract.
//
// Design (simple and right first). One block of 256 threads per (b, h)
// walks the chunks in order; the state stays in shared memory for the
// whole walk (N x P floats, 32 KB at N = 128, P = 64). Each chunk's x, B,
// C and dt are staged in shared memory as float32, 16 bytes a load where
// the rows allow it (they do in the model: 64 or 128 contiguous elements
// at 16-byte aligned strides); one thread takes the running sum of
// dt * a. The Q x Q scores are
// formed 32 query rows at a time (a 32 x Q tile in shared memory) and
// consumed at once by the y product of the same rows; column tiles wholly
// above the diagonal are skipped. All products run on CUDA cores from
// register tiles, their operands read from shared memory as float4: along
// the reduction for the scores (B rows padded to an odd number of float4s,
// so the 8 rows of a quarter warp fall on distinct banks), along the
// output columns for the y and state products. Tensor cores, TMA and the
// three-pass form (chunk states in parallel, a short inter-chunk scan,
// then the outputs) are later work.
//
// Bound: at the path's shape (B=1, L=4096, H=80, G=1, P=64, N=128,
// Q=128, bfloat16) the full Q x Q products the TPU kernel computes are
// 2 Q^2 N + 2 Q^2 P + 4 Q N P = 10.49 MFLOP per (head, chunk), 26.8 GFLOP
// in all: 27 us at the H100's 989 TFLOP/s; the bytes (x and y dominate,
// 87 MB) take 26 us at 3.35 TB/s. One block per (b, h) fills 80 of the
// 132 SMs at B = 1, and the products run on float32 FMAs, so the kernel
// is far from either bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;
constexpr int kRows = 32;       // score rows formed per pass
constexpr int kLoadUnroll = 8;  // global loads in flight a thread

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* bm;
  const void* cm;
  void* y;
  int L, H, G, P, N, Q;
  int64_t sx_b, sx_l, sx_h;      // strides in elements; the last dim is 1
  int64_t sdt_b, sdt_l, sdt_h;
  int64_t sb_b, sb_l, sb_g;
  int64_t sc_b, sc_l, sc_g;
};

// Shared-memory geometry of one block, in floats. Rows are padded to
// whole float4s (zeros past N, P or Q); B and C rows to an odd number of
// float4s.
struct Geometry {
  int Qp, Np, Pp, ldb;
  __host__ __device__ Geometry(int Q, int N, int P)
      : Qp((Q + 3) & ~3), Np((N + 3) & ~3), Pp((P + 3) & ~3),
        ldb(4 * ((((N + 3) & ~3) / 4) | 1)) {}
  __host__ __device__ int floats() const {
    return Np * Pp        // S (N x P)
           + Qp * Pp      // x (Q x P)
           + 2 * Qp * ldb // B, C (Q x N)
           + kRows * Qp   // scores of kRows query rows (kRows x Q)
           + 4 * Qp;      // cs, dt, exp(cs), w
  }
};

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
      if (i < Q && j < Q)
        SC[(warp + 8 * m) * ldsc + j] =
            j <= i ? acc[m][n] * expf(cs[i] - cs[j]) * dts[j] : 0.0f;
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(Args args) {
  extern __shared__ __align__(16) float smem[];
  const int Q = args.Q, N = args.N, P = args.P, L = args.L, H = args.H;
  const Geometry geo(Q, N, P);
  const int Np = geo.Np, Pp = geo.Pp, ldb = geo.ldb, ldsc = geo.Qp;
  float* Ss = smem;                 // Np x Pp state
  float* Xs = Ss + Np * Pp;         // Qp x Pp
  float* Bs = Xs + geo.Qp * Pp;     // Qp x ldb
  float* Cs = Bs + geo.Qp * ldb;    // Qp x ldb
  float* SC = Cs + geo.Qp * ldb;    // kRows x ldsc
  float* cs = SC + kRows * ldsc;    // Qp
  float* dts = cs + geo.Qp;         // Qp
  float* ecs = dts + geo.Qp;        // Qp
  float* w = ecs + geo.Qp;          // Qp

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = h / (H / args.G);
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int tx = t & 15, ty = t >> 4;  // 16 x 16 threads: y and state
  const float a_h = args.a[h];
  const T* xb = static_cast<const T*>(args.x) + b * args.sx_b + h * args.sx_h;
  const float* dtb = args.dt + b * args.sdt_b + h * args.sdt_h;
  const T* bb = static_cast<const T*>(args.bm) + b * args.sb_b +
                grp * args.sb_g;
  const T* cb = static_cast<const T*>(args.cm) + b * args.sc_b +
                grp * args.sc_g;
  T* yb = static_cast<T*>(args.y) + (int64_t(b) * L * H + h) * P;

  // zeros everywhere: the state starts at zero, and the padding past N, P
  // and Q is never written
  for (int i = t; i < geo.floats(); i += kThreads) smem[i] = 0.0f;
  __syncthreads();

  const int pc = min(4 * tx, Pp - 4);  // this thread's 4 columns of P
  for (int l0 = 0; l0 < L; l0 += Q) {
    // stage the chunk; steps past L are zeros (dt = 0: no decay, no input)
    const int valid = min(Q, L - l0);
    if (t < Q) {
      const float d = t < valid ? dtb[(l0 + t) * args.sdt_l] : 0.0f;
      dts[t] = d;
      cs[t] = d * a_h;
    }
    stage(xb + l0 * args.sx_l, args.sx_l, Q, valid, P, Xs, Pp, t);
    stage(bb + l0 * args.sb_l, args.sb_l, Q, valid, N, Bs, ldb, t);
    stage(cb + l0 * args.sc_l, args.sc_l, Q, valid, N, Cs, ldb, t);
    __syncthreads();
    if (t == 0) {
      // the running sum of dt * a, added in the plain version's order (a
      // sequential scan, as torch.cumsum along a non-innermost dim runs on
      // the card and on the CPU): cs reaches tens within a chunk, so each
      // decay exp(cs_i - cs_j) keeps only the digits that survive the
      // subtraction, and the two versions then round them alike
      float run = 0.0f;
      for (int i = 0; i < Q; ++i) {
        run += cs[i];
        cs[i] = run;
      }
    }
    __syncthreads();
    const float cs_last = cs[Q - 1];
    if (t < Q) {
      ecs[t] = expf(cs[t]);
      w[t] = expf(cs_last - cs[t]) * dts[t];
    }
    __syncthreads();

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
      // scores times x, plus exp(cs_i) times C_i . S (the state before
      // this chunk)
      float yi[2][4] = {}, yo[2][4] = {};
      rows2_times(yi, SC + ty * ldsc, SC + (ty + 16) * ldsc, Xs + pc, Pp,
                  (jmax + 3) & ~3);
      rows2_times(yo, Cs + min(r0 + ty, Q - 1) * ldb,
                  Cs + min(r0 + ty + 16, Q - 1) * ldb, Ss + pc, Pp, Np);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r0 + ty + 16 * r;
        if (i >= Q || l0 + i >= L) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = 4 * tx + c;
          if (p < P)
            yb[int64_t(l0 + i) * H * P + p] =
                from_f32<T>(yi[r][c] + ecs[i] * yo[r][c]);
        }
      }
      __syncthreads();             // the next rows overwrite the scores
    }

    // state update: S <- exp(cs_Q) S + (B * w)^T x
    for (int idx = t; idx < Q * N; idx += kThreads) {
      const int j = idx / N, n = idx - j * N;
      Bs[j * ldb + n] *= w[j];
    }
    __syncthreads();
    {
      float acc[8][4] = {};
      const int nb0 = min(4 * ty, Np - 4), nb1 = min(64 + 4 * ty, Np - 4);
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
      const float decay = expf(cs_last);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int n = 4 * ty + 64 * (m / 4) + m % 4;
        if (n >= N) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = 4 * tx + c;
          if (p < P) Ss[n * Pp + p] = decay * Ss[n * Pp + p] + acc[m][c];
        }
      }
    }
    __syncthreads();               // the next chunk restages B and x
  }
}

template <typename T>
int launch(const Args& args, int B, cudaStream_t stream) {
  const int smem = Geometry(args.Q, args.N, args.P).floats() *
                   static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(args.H, B);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes (kernels/ssd_scan/kernel.py).
// x (B, L, H, P), b and c (B, L, G, N) of `dtype` (0 = float32,
// 1 = bfloat16), dt (B, L, H) float32, a (H,) float32 contiguous, y
// (B, L, H, P) of `dtype` contiguous. `strides` holds 12 element strides:
// x's (b, l, h), dt's (b, l, h), b's (b, l, g) and c's (b, l, g); the last
// dims of x, b and c are contiguous. Takes 1 <= Q <= 128, 1 <= N <= 128,
// 1 <= P <= 64, H a multiple of G, B <= 65535. Launches on `stream`;
// returns cudaGetLastError() (0 = launched) or -1 for a shape or type it
// does not take.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* a,
                            const void* b, const void* c, void* y, int dtype,
                            int B, int L, int H, int G, int P, int N, int Q,
                            const int64_t* strides, void* stream) {
  if (B <= 0 || B > 65535 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 ||
      P <= 0 || P > kMaxP || N <= 0 || N > kMaxN || Q <= 0 || Q > kMaxQ)
    return -1;
  Args args{x, dt, a, b, c, y, L, H, G, P, N, Q,
            strides[0], strides[1], strides[2], strides[3], strides[4],
            strides[5], strides[6], strides[7], strides[8], strides[9],
            strides[10], strides[11]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(args, B, st);
  if (dtype == 1) return launch<__nv_bfloat16>(args, B, st);
  return -1;
}
