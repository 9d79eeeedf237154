// Mamba-2 SSD chunked scan, chunk-parallel on the tensor cores: five
// kernels, each parallel over every (batch, head, chunk) it touches.
//
// Replaces: src/repro/kernels/ssd_scan.py::_ssd_kernel (the Pallas TPU kernel
// behind ssd_scan), and adds what the model's caller needs: an optional f32
// initial state and the final state as a second output.
//
// Per chunk c of Q rows (cum = inclusive cumsum of dtA over the chunk):
//   y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//       + exp(cum_i) (C_i . s_c)
//   s_{c+1} = exp(cum_Q) s_c + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T
// in float32, y stored in the inputs' type.
//
// What bounds it on an H100: bytes, once the products are on the tensor
// cores.  At mamba2-1.3b's prefill shape (B=4, S=2048, H=64, P=64, N=128,
// Q=256, bf16) x and y are 134 MB, and the chunk states are written (67 MB
// of f32), passed (read, and written back as 34 MB of bf16) and read:
// ~0.1 ms at 3.35 TB/s, while the ~26 GFLOP of products take ~26 us at
// the bf16 tensor rate.
//
// Design (the Mamba-2 paper's GPU decomposition, arXiv:2405.21060 §6):
//   1. chunk_cumsum, one thread per (b, chunk, head): cum, added in the
//      plain version's order, and dt as f32;
//   2. chunk_cb, one block per (b, chunk, 64 x 64 tile of the lower
//      triangle): CB = C B^T, computed once and shared by all H heads;
//   3. chunk_state, one block per (b, head, chunk): the chunk's own state
//      sum_j (exp(cum_Q - cum_j) dt_j x_j) B_j^T, a (P x Q)(Q x N) product;
//   4. state_pass, per (b, head) and 256 state entries: sequential over the
//      chunks but elementwise, it writes the state entering each chunk and
//      the final state;
//   5. chunk_out, one block per (b, head, chunk, 64-row tile): the weights
//      CB o exp(cum_i - cum_j) o dt_j on j <= i (masked before exp, so no
//      positive argument is formed) times x, plus exp(cum_i) (C s^T).
// chunk_state and chunk_out walk their K dimension in tiles of 64 through a
// ring of kRing shared-memory buffers that cp.async fills two tiles ahead.
// The products are warp-level mma.sync with f32 accumulation.  bf16
// inputs: CB and the entering states are stored in bf16, the tiles are
// bf16 and the products m16n8k16 from ldmatrix; x, B and C are exact
// there, and the f32 quantities (C.B^T, the weights CB o decay o dt, the
// x rows times their state weight, the entering state) are rounded to
// bf16 (relative 2^-9, as the bf16 output is, against the 5e-2 bound), as
// the Mamba-2 reference kernels round their weights and states.  f32
// inputs: everything stays f32, the products m16n8k8 on TF32 with every
// operand split into a TF32 high part and a TF32 remainder and three
// products summed (3xTF32), which keeps float32 accuracy.  Scratch
// (cum, dt in f32, CB, chunk states, bf16 entering states) comes from the
// caller; its size is ssd_scan_scratch_bytes().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTile = 64;           // rows of a row or column tile
constexpr int kPMax = 64;           // head dim P the kernels cover
constexpr int kNMax = 128;          // state dim N the kernels cover
constexpr int kThreads = 256;       // 8 warps
constexpr int kKernels = 5;         // launches of one call
constexpr int kRing = 3;            // K-tile buffers of chunk_state, chunk_out

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

// x rounded to the nearest TF32 value, as f32 bits whose low 13 mantissa
// bits are zero (so that x minus it is the exact remainder; the tensor
// cores ignore those bits, and cvt does not promise to clear them)
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// d += a b over one 16 x 8 x 8 tile (PTX fragment layouts: a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4,
// n g); d0, d1 (g, 2t, 2t + 1), d2, d3 (g + 8, ...); g = lane / 4, t =
// lane % 4).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[MT][NT] += A B for one warp: A(m, k) = A[m * sam + k * sak] over MT
// 16-row tiles, B(k, n) = B[k * sbk + n * sbn] over NT 8-column tiles, k in
// [0, K) (K a multiple of 8), both f32 in shared memory and offset to the
// warp's tile, as 3xTF32: each operand split into a TF32 value and a TF32
// remainder, hi*hi + hi*lo + lo*hi (float32 accuracy).
template <int MT, int NT>
__device__ __forceinline__ void warp_gemm(float (&acc)[MT][NT][4],
                                          const float* A, int sam, int sak,
                                          const float* B, int sbk, int sbn,
                                          int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; k += 8) {
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* a = A + (mt * 16 + g) * sam + (k + t) * sak;
      const float v[4] = {a[0], a[8 * sam], a[4 * sak], a[8 * sam + 4 * sak]};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ah[mt][q] = tf32(v[q]);
        al[mt][q] = tf32(v[q] - __uint_as_float(ah[mt][q]));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* b = B + (k + t) * sbk + (nt * 8 + g) * sbn;
      const float v[2] = {b[0], b[4 * sbk]};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        bh[nt][q] = tf32(v[q]);
        bl[nt][q] = tf32(v[q] - __uint_as_float(bh[nt][q]));
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma(acc[mt][nt], al[mt], bh[nt]);   // the small terms first
        mma(acc[mt][nt], ah[mt], bl[nt]);
        mma(acc[mt][nt], ah[mt], bh[nt]);
      }
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b over one 16 x 8 x 16 tile of bf16 (fragments as ldmatrix gives
// them: a from four 8 x 8 blocks (rows 0-7 | 8-15) x (k 0-7 | 8-15), b
// from k 0-7 and 8-15 of 8 columns).
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[MT][NT] += A B for one warp on bf16 tiles in shared memory, k in
// [0, K) (K a multiple of 16), A and B offset to the warp's tile:
// A(m, k) = kAT ? A[k * lda + m] : A[m * lda + k], B(k, n) = kBT ?
// B[k * ldb + n] : B[n * ldb + k] (NT even).  Rows are 16-byte aligned and
// lda, ldb are 16 bytes past a multiple of 128, so each 8-row ldmatrix
// hits all banks once.
template <int MT, int NT, bool kAT, bool kBT>
__device__ __forceinline__ void warp_gemm_bf16(float (&acc)[MT][NT][4],
                                               const __nv_bfloat16* A,
                                               int lda,
                                               const __nv_bfloat16* B,
                                               int ldb, int K) {
  const int lane = threadIdx.x & 31, r = lane & 7, q = lane >> 3;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (kAT)
        ldsm_x4_t(a[mt], A + (k0 + r + (q >> 1) * 8) * lda + mt * 16 +
                             (q & 1) * 8);
      else
        ldsm_x4(a[mt], A + (mt * 16 + r + (q & 1) * 8) * lda + k0 +
                           (q >> 1) * 8);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      if (kBT)
        ldsm_x4_t(b, B + (k0 + r + (q & 1) * 8) * ldb + np * 16 +
                         (q >> 1) * 8);
      else
        ldsm_x4(b, B + (np * 16 + r + (q >> 1) * 8) * ldb + k0 +
                       (q & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// The products of the kernels over K (a tile of 64 unless given), by the
// type of the tiles: f32 tiles (f32 inputs) on 3xTF32, bf16 tiles (bf16
// inputs; the f32 quantities rounded to bf16) on bf16 mma.sync.  mk_kn:
// A [m][k], B [k][n]; mk_nk: A [m][k], B [n][k]; km_kn: A [k][m], B [k][n].
template <int MT, int NT, int K = kTile>
__device__ __forceinline__ void mk_kn(float (&acc)[MT][NT][4], const float* A,
                                      int lda, const float* B, int ldb) {
  warp_gemm(acc, A, lda, 1, B, ldb, 1, K);
}
template <int MT, int NT, int K = kTile>
__device__ __forceinline__ void mk_kn(float (&acc)[MT][NT][4],
                                      const __nv_bfloat16* A, int lda,
                                      const __nv_bfloat16* B, int ldb) {
  warp_gemm_bf16<MT, NT, false, true>(acc, A, lda, B, ldb, K);
}
template <int MT, int NT, int K = kTile>
__device__ __forceinline__ void mk_nk(float (&acc)[MT][NT][4], const float* A,
                                      int lda, const float* B, int ldb) {
  warp_gemm(acc, A, lda, 1, B, 1, ldb, K);
}
template <int MT, int NT, int K = kTile>
__device__ __forceinline__ void mk_nk(float (&acc)[MT][NT][4],
                                      const __nv_bfloat16* A, int lda,
                                      const __nv_bfloat16* B, int ldb) {
  warp_gemm_bf16<MT, NT, false, false>(acc, A, lda, B, ldb, K);
}
template <int MT, int NT, int K = kTile>
__device__ __forceinline__ void km_kn(float (&acc)[MT][NT][4], const float* A,
                                      int lda, const float* B, int ldb) {
  warp_gemm(acc, A, 1, lda, B, ldb, 1, K);
}
template <int MT, int NT, int K = kTile>
__device__ __forceinline__ void km_kn(float (&acc)[MT][NT][4],
                                      const __nv_bfloat16* A, int lda,
                                      const __nv_bfloat16* B, int ldb) {
  warp_gemm_bf16<MT, NT, true, true>(acc, A, lda, B, ldb, K);
}

// Row strides of the tiles by element type: 64- and 128-wide [m][k] (or
// [n][k]) tiles and 64- and 128-wide [k][n] tiles (f32: 4 and 8 words past
// a multiple of 32, for the TF32 fragments' single loads; bf16: 16 bytes
// past a multiple of 128, for ldmatrix).
template <typename E>
struct Ld;
template <>
struct Ld<float> {
  static constexpr int mk = kTile + 4, mk2 = kNMax + 4, kn = kTile + 8,
                       kn2 = kNMax + 8;
};
template <>
struct Ld<__nv_bfloat16> {
  static constexpr int mk = kTile + 8, mk2 = kNMax + 8, kn = kTile + 8,
                       kn2 = kNMax + 8;
};

__device__ __forceinline__ void put4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void put4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
}

// f(row, col, value) for every accumulator entry of a warp whose tile
// starts at (m0, n0).
template <int MT, int NT, class F>
__device__ __forceinline__ void for_each(const float (&acc)[MT][NT][4],
                                         int m0, int n0, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        f(m0 + mt * 16 + g + (q >> 1) * 8, n0 + nt * 8 + 2 * t + (q & 1),
          acc[mt][nt][q]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A kTile x W tile of T copied as it is into shared memory (row stride
// ld), element (r, c) from src[r * rs + c], zero at or past `valid` rows
// or `ncols` columns.  vec16: 16-byte cp.async (ncols, rs and src are
// multiples of 16 bytes; the caller waits); else plain element copies.
template <typename T, int W = kTile>
__device__ __forceinline__ void copy_tile(T* dst, int ld,
                                          const T* __restrict__ src,
                                          size_t rs, int valid, int ncols,
                                          bool vec16) {
  if (vec16) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    constexpr int kRow = W / kPer;        // chunks of a row
    for (int e = threadIdx.x; e < kTile * kRow; e += kThreads) {
      const int r = e / kRow, c = e % kRow * kPer;
      const bool in = r < valid && c < ncols;
      cp_async16(dst + r * ld + c, in ? src + r * rs + c : src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * W; e += kThreads) {
      const int r = e / W, c = e % W;
      dst[r * ld + c] =
          (r < valid && c < ncols) ? src[r * rs + c] : from_f32<T>(0.f);
    }
  }
}

// The mirror of copy_tile: rows [0, valid) x cols [0, ncols) of a tile in
// shared memory (row stride ld) to dst[r * rs + c], 16 bytes a store where
// vec16 (ncols, rs and dst multiples of 16 bytes), else element by element.
template <int W, typename E>
__device__ __forceinline__ void store_tile(E* __restrict__ dst, size_t rs,
                                           const E* src, int ld, int valid,
                                           int ncols, bool vec16) {
  if (vec16) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(E));
    constexpr int kRow = W / kPer;
    for (int e = threadIdx.x; e < kTile * kRow; e += kThreads) {
      const int r = e / kRow, c = e % kRow * kPer;
      if (r < valid && c < ncols)
        *reinterpret_cast<uint4*>(dst + r * rs + c) =
            *reinterpret_cast<const uint4*>(src + r * ld + c);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * W; e += kThreads) {
      const int r = e / W, c = e % W;
      if (r < valid && c < ncols) dst[r * rs + c] = src[r * ld + c];
    }
  }
}

struct Dims {
  int S, H, P, N, Q, nc, nt;
  bool vx16, vc16, vq16;           // 16-byte copies: x rows, B, C and state
                                   // rows, CB rows
};

// ---- 1. cumsum of dtA over each chunk --------------------------------------
// One thread per (b, chunk, head) adds in order, as torch.cumsum does along
// an outer dimension, so that cum equals the plain version's bit for bit:
// exp(cum_i - cum_j) takes the difference of two sums of up to Q terms,
// and another order of addition moves it by several ulps of cum.  cum
// keeps dtA's (b, S, H) layout, so neighbouring threads (heads) read and
// write neighbouring words.  dt goes beside it as f32, for 4-byte copies.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    chunk_cumsum(const T* __restrict__ dt, const T* __restrict__ dtA,
                 float* __restrict__ cum, float* __restrict__ dtf, Dims d,
                 long long chains) {
  const long long w = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (w >= chains) return;
  const int h = static_cast<int>(w % d.H);
  const long long bc = w / d.H;
  const size_t o = static_cast<size_t>(bc) * d.Q * d.H + h;  // (b, c Q, h)
  constexpr int kAhead = 16;              // loads in flight a thread
  float acc = 0.f;
  for (int i0 = 0; i0 < d.Q; i0 += kAhead) {
    float v[kAhead], u[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const size_t t = o + static_cast<size_t>(i0 + k) * d.H;
      v[k] = i0 + k < d.Q ? to_f32(dtA[t]) : 0.f;
      u[k] = i0 + k < d.Q ? to_f32(dt[t]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (i0 + k >= d.Q) break;
      const size_t t = o + static_cast<size_t>(i0 + k) * d.H;
      acc = __fadd_rn(acc, v[k]);
      cum[t] = acc;
      dtf[t] = u[k];
    }
  }
}

// ---- 2. CB = C B^T on the lower triangle, once per (b, chunk) -------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    chunk_cb(const T* __restrict__ Bm, const T* __restrict__ Cm,
             T* __restrict__ cb, Dims d) {
  using L = Ld<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* cs = reinterpret_cast<T*>(smem);     // [kTile i][L::mk2] C_i rows
  T* bs = cs + kTile * L::mk2;            // [kTile j][L::mk2] B_j rows
  int it = 0;
  const int x = blockIdx.x;
  while ((it + 1) * (it + 2) / 2 <= x) ++it;
  const int jt = x - it * (it + 1) / 2;
  const int c = blockIdx.y, b = blockIdx.z;
  const size_t row = static_cast<size_t>(b) * d.S + c * d.Q;
  const int i0 = it * kTile, j0 = jt * kTile;
  copy_tile<T, kNMax>(cs, L::mk2, Cm + (row + i0) * d.N, d.N,
                      min(kTile, d.Q - i0), d.N, d.vc16);
  copy_tile<T, kNMax>(bs, L::mk2, Bm + (row + j0) * d.N, d.N,
                      min(kTile, d.Q - j0), d.N, d.vc16);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  float acc[1][4][4];
  zero(acc);
  // A(i, n) = C_i[n]; B(n, j) = B_j[n]
  mk_nk<1, 4, kNMax>(acc, cs + wm * 16 * L::mk2, L::mk2,
                     bs + wn * 32 * L::mk2, L::mk2);
  T* out = cb + (static_cast<size_t>(b) * d.nc + c) * d.Q * d.Q;
  for_each(acc, i0 + wm * 16, j0 + wn * 32, [&](int i, int j, float v) {
    if (i < d.Q && j < d.Q)
      out[static_cast<size_t>(i) * d.Q + j] = from_f32<T>(v);
  });
}

// ---- 3. each chunk's own state --------------------------------------------
// K runs over the chunk's 64-row tiles of j, in a ring of kRing buffers:
// cp.async brings tile j + 2 (x, B, cum and dt rows) while tile j is
// multiplied and tile j + 1's x rows are scaled by their weight in place.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    chunk_state(const T* __restrict__ x, const float* __restrict__ dtf,
                const T* __restrict__ Bm, const float* __restrict__ cum,
                float* __restrict__ states, Dims d) {
  using L = Ld<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);     // [kRing][kTile j][L::kn] w_j x_j
  T* bs = xs + kRing * kTile * L::kn;     // [kRing][kTile j][L::kn2] B_j
  float* cj_s = reinterpret_cast<float*>(bs + kRing * kTile * L::kn2);
  float* dj_s = cj_s + kRing * kTile;     // [kRing][kTile] cum_j, dt_j
  float* wj = dj_s + kRing * kTile;       // [kTile] exp(cum_Q - cum_j) dt_j
  const int h = blockIdx.x % d.H;
  const int c = blockIdx.x / d.H, b = blockIdx.y;
  const size_t row = static_cast<size_t>(b) * d.S + c * d.Q;
  const size_t hrow = row * d.H + h;      // (b, c Q, h) of dt and cum
  const float cum_last = cum[hrow + static_cast<size_t>(d.Q - 1) * d.H];
  const int tid = threadIdx.x, warp = tid >> 5, wm = warp & 1, wn = warp >> 1;
  const int nk = (d.Q + kTile - 1) / kTile;
  auto fetch = [&](int k) {
    if (k < nk) {
      const int buf = k % kRing, j0 = k * kTile, jv = min(kTile, d.Q - j0);
      copy_tile(xs + buf * kTile * L::kn, L::kn,
                x + ((row + j0) * d.H + h) * d.P,
                static_cast<size_t>(d.H) * d.P, jv, d.P, d.vx16);
      copy_tile<T, kNMax>(bs + buf * kTile * L::kn2, L::kn2,
                          Bm + (row + j0) * d.N, d.N, jv, d.N, d.vc16);
      if (tid < jv) {
        const size_t t = hrow + static_cast<size_t>(j0 + tid) * d.H;
        cp_async4(cj_s + buf * kTile + tid, cum + t);
        cp_async4(dj_s + buf * kTile + tid, dtf + t);
      }
    }
    cp_commit();                          // empty past the last tile
  };
  auto finish = [&](int k) {              // w_j x_j in place
    const int buf = k % kRing, jv = min(kTile, d.Q - k * kTile);
    cp_wait<kRing - 2>();                 // this thread's copies of tile k
    if (tid < kTile)                      // (its own cum_j, dt_j)
      wj[tid] = tid < jv ? expf(cum_last - cj_s[buf * kTile + tid]) *
                               dj_s[buf * kTile + tid]
                         : 0.f;
    __syncthreads();                      // everyone's copies, the weights
    T* xb = xs + buf * kTile * L::kn;
    for (int e = tid; e < kTile * kPMax / 4; e += kThreads) {
      const int j = e / (kPMax / 4), p = e % (kPMax / 4) * 4;
      T* q = xb + j * L::kn + p;
      const float w = wj[j];
      put4(q, make_float4(to_f32(q[0]) * w, to_f32(q[1]) * w,
                          to_f32(q[2]) * w, to_f32(q[3]) * w));
    }
  };
  float acc[2][4][4];
  zero(acc);
  fetch(0);
  fetch(1);
  finish(0);
  __syncthreads();
  for (int k = 0; k < nk; ++k) {
    fetch(k + 2);
    const int buf = k % kRing;
    // A(p, j) = xs[j][p]; B(j, n) = bs[j][n]
    km_kn(acc, xs + buf * kTile * L::kn + wm * 32, L::kn,
          bs + buf * kTile * L::kn2 + wn * 32, L::kn2);
    if (k + 1 < nk) {
      __syncthreads();                    // wj is read by the scaling
      finish(k + 1);
    }
    __syncthreads();
  }
  cp_wait<0>();
  // the state through shared memory, for whole-row stores
  float* so = reinterpret_cast<float*>(smem);   // [kPMax][kLdS]
  constexpr int kLdS = kNMax + 4;
  for_each(acc, wm * 32, wn * 32,
           [&](int p, int n, float v) { so[p * kLdS + n] = v; });
  __syncthreads();
  store_tile<kNMax>(states + ((static_cast<size_t>(b) * d.H + h) * d.nc + c) *
                                 static_cast<size_t>(d.P) * d.N,
                    d.N, so, kLdS, d.P, d.N, d.N % 4 == 0);
}

// ---- 4. state passing: chunk states -> states entering each chunk ---------
// The entering states go to `ent` in the inputs' type, the type chunk_out
// multiplies them in (f32: in place over the chunk states).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    state_pass(float* __restrict__ states, T* ent,
               const float* __restrict__ cum, const float* __restrict__ s0,
               float* __restrict__ s_out, Dims d) {
  const int pn = d.P * d.N;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const size_t bh = blockIdx.y;
  if (e >= pn) return;
  float s = s0 != nullptr ? s0[bh * pn + e] : 0.f;
  const float* st = states + bh * d.nc * static_cast<size_t>(pn) + e;
  T* en = ent + bh * d.nc * static_cast<size_t>(pn) + e;
  // cum at the last row of chunk c: (b, c Q + Q - 1, h)
  const float* cl = cum + (bh / d.H * static_cast<size_t>(d.S) + d.Q - 1) *
                              d.H + bh % d.H;
  const size_t cstep = static_cast<size_t>(d.Q) * d.H;
  constexpr int kBatch = 8;               // loads in flight a thread
  for (int c0 = 0; c0 < d.nc; c0 += kBatch) {
    float own[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      own[u] = c0 + u < d.nc ? st[static_cast<size_t>(c0 + u) * pn] : 0.f;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (c0 + u >= d.nc) break;
      en[static_cast<size_t>(c0 + u) * pn] = from_f32<T>(s);
      s = s * expf(cl[(c0 + u) * cstep]) + own[u];
    }
  }
  s_out[bh * pn + e] = s;
}

// ---- 5. chunk output -------------------------------------------------------
// One product over K tiles of 64: first the N columns of C_i against the
// entering state (the rows then scaled by exp(cum_i)), then, for each
// column tile j <= i, the weights against x_j.  A tile j wholly below the
// diagonal factors its decay through m, its last row: exp(cum_i - cum_j) =
// exp(cum_i - cum_m) exp(cum_m - cum_j), both arguments <= 0, so its
// weights are CB[i][j] (exp(cum_m - cum_j) dt_j) exp(cum_i - cum_m): 128
// exps a tile instead of 4096 (rows at or past the chunk's end get a row
// factor of 0).  The
// diagonal tile forms exp(cum_i - cum_j) only where j <= i.  A ring of
// kRing buffers: cp.async brings K tile k + 2 (C and state rows, or CB, x,
// cum and dt rows) while tile k is multiplied and tile k + 1's weights
// are formed over its CB in place.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : 2)
    chunk_out(const T* __restrict__ x, const float* __restrict__ dtf,
              const T* __restrict__ Cm, const T* __restrict__ cb,
              const float* __restrict__ cum, const T* __restrict__ ent,
              T* __restrict__ y, Dims d) {
  using L = Ld<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);     // [kRing][kTile i][L::mk] A tiles
  T* bs = as + kRing * kTile * L::mk;     // [kRing][kTile][L::kn] B tiles
  float* cum_i = reinterpret_cast<float*>(bs + kRing * kTile * L::kn);
  // per buffer, [kRing][kTile] each: cum_j and dt_j as copied; then the
  // diagonal tile's cum_j and dt_j, or a tile below it's exp(cum_m -
  // cum_j) dt_j (by j) and exp(cum_i - cum_m) (by i)
  float* cj_s = cum_i + kTile;
  float* dj_s = cj_s + kRing * kTile;
  float* u_j = dj_s + kRing * kTile;
  float* v_j = u_j + kRing * kTile;
  const int it = blockIdx.x % d.nt;
  const int bhc = blockIdx.x / d.nt;      // (h, c) with h fastest
  const int h = bhc % d.H, c = bhc / d.H, b = blockIdx.y;
  const int i0 = it * kTile, iv = min(kTile, d.Q - i0);
  const size_t row = static_cast<size_t>(b) * d.S + c * d.Q;
  const size_t hrow = row * d.H + h;      // (b, c Q, h) of dt and cum
  const T* s_in = ent + ((static_cast<size_t>(b) * d.H + h) * d.nc + c) *
                            static_cast<size_t>(d.P) * d.N;
  const T* cbc = cb + (static_cast<size_t>(b) * d.nc + c) * d.Q * d.Q +
                 static_cast<size_t>(i0) * d.Q;
  const int tid = threadIdx.x, warp = tid >> 5, wm = warp & 3, wn = warp >> 2;
  const int g8 = (tid & 31) >> 2;         // this thread's rows: g8, g8 + 8
  const int ncs = (d.N + kTile - 1) / kTile;   // K tiles of C . s^T
  const int nk = ncs + it + 1;

  if (tid < kTile)
    cum_i[tid] =
        tid < iv ? cum[hrow + static_cast<size_t>(i0 + tid) * d.H] : 0.f;
  // start K tile k into buffer buf, all by cp.async
  auto fetch = [&](int k) {
    const int buf = k % kRing;
    T* a = as + buf * kTile * L::mk;
    T* bt = bs + buf * kTile * L::kn;
    if (k < ncs) {
      const int n0 = k * kTile;
      copy_tile(a, L::mk, Cm + (row + i0) * d.N + n0, d.N, iv, d.N - n0,
                d.vc16);                  // C_i[n]
      copy_tile(bt, L::mk, s_in + n0, d.N, d.P, d.N - n0, d.vc16);  // s[p][n]
    } else if (k < nk) {
      const int j0 = (k - ncs) * kTile, jv = min(kTile, d.Q - j0);
      copy_tile(a, L::mk, cbc + j0, d.Q, iv, jv, d.vq16);       // CB[i][j]
      copy_tile(bt, L::kn, x + ((row + j0) * d.H + h) * d.P,
                static_cast<size_t>(d.H) * d.P, jv, d.P, d.vx16);  // x_j[p]
      if (tid < jv) {
        const size_t t = hrow + static_cast<size_t>(j0 + tid) * d.H;
        cp_async4(cj_s + buf * kTile + tid, cum + t);
        cp_async4(dj_s + buf * kTile + tid, dtf + t);
      }
    }
    cp_commit();                          // empty past the last tile
  };
  // finish K tile k once its copies have landed: for a tile of j, the
  // weights over CB in place.  Ends with the block in step.
  auto finish = [&](int k) {
    cp_wait<kRing - 2>();                 // this thread's copies of tile k
    __syncthreads();                      // everyone's
    if (k < ncs) return;
    const int buf = k % kRing;
    const int j0 = (k - ncs) * kTile, jv = min(kTile, d.Q - j0);
    const bool diag = k == nk - 1;
    const float* cjb = cj_s + buf * kTile;
    const float* djb = dj_s + buf * kTile;
    float* ub = u_j + buf * kTile;
    float* vb = v_j + buf * kTile;
    if (tid < kTile) {
      if (diag) {
        ub[tid] = tid < jv ? cjb[tid] : 0.f;
        vb[tid] = tid < jv ? djb[tid] : 0.f;
      } else {                            // jv == kTile below the diagonal
        const float cm = cjb[kTile - 1];
        ub[tid] = expf(cm - cjb[tid]) * djb[tid];
        vb[tid] = tid < iv ? expf(cum_i[tid] - cm) : 0.f;
      }
    }
    __syncthreads();                      // u_j, v_j
    T* a = as + buf * kTile * L::mk;
    for (int e = tid; e < kTile * kTile / 4; e += kThreads) {
      const int i = e / (kTile / 4), j = e % (kTile / 4) * 4;
      T* p = a + i * L::mk + j;
      float w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float cv = to_f32(p[u]);
        if (!diag)
          w[u] = cv * ub[j + u] * vb[i];
        else   // exp of a positive cum_i - cum_j is never formed (the
               // jnp version forms it and masks it after)
          w[u] = (i < iv && j + u < jv && j0 + j + u <= i0 + i)
                     ? cv * expf(cum_i[i] - ub[j + u]) * vb[j + u]
                     : 0.f;
      }
      put4(p, make_float4(w[0], w[1], w[2], w[3]));
    }
  };

  float acc[1][4][4];
  zero(acc);
  fetch(0);
  fetch(1);
  finish(0);
  __syncthreads();
  for (int k = 0; k < nk; ++k) {
    fetch(k + 2);
    const int buf = k % kRing;
    const T* a = as + buf * kTile * L::mk + wm * 16 * L::mk;
    const T* bt = bs + buf * kTile * L::kn;
    if (k < ncs) {   // A(i, n) = a[i][n]; B(n, p) = bt[p][n]
      mk_nk(acc, a, L::mk, bt + wn * 32 * L::mk, L::mk);
      if (k == ncs - 1) {                 // C_i . s times exp(cum_i)
        const float e0 = expf(cum_i[wm * 16 + g8]);
        const float e1 = expf(cum_i[wm * 16 + g8 + 8]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          acc[0][nt][0] *= e0;
          acc[0][nt][1] *= e0;
          acc[0][nt][2] *= e1;
          acc[0][nt][3] *= e1;
        }
      }
    } else {         // A(i, j) = a[i][j]; B(j, p) = bt[j][p]
      mk_kn(acc, a, L::mk, bt + wn * 32, L::kn);
    }
    if (k + 1 < nk) finish(k + 1);
    __syncthreads();
  }
  cp_wait<0>();
  // y through shared memory, for whole-row stores
  for_each(acc, wm * 16, wn * 32,
           [&](int i, int p, float v) { as[i * L::mk + p] = from_f32<T>(v); });
  __syncthreads();
  store_tile<kTile>(y + ((row + i0) * d.H + h) * d.P,
                    static_cast<size_t>(d.H) * d.P, as, L::mk, iv, d.P,
                    d.vx16);
}

template <typename T>
constexpr size_t cb_smem() {
  return 2 * kTile * Ld<T>::mk2 * sizeof(T);
}
template <typename T>
constexpr size_t state_smem() {
  return std::max(kRing * kTile * (Ld<T>::kn + Ld<T>::kn2) * sizeof(T) +
                      (2 * kRing + 1) * kTile * sizeof(float),
                  kPMax * (kNMax + 4) * sizeof(float));
}
template <typename T>
constexpr size_t out_smem() {
  return kRing * kTile * (Ld<T>::mk + Ld<T>::kn) * sizeof(T) +
         (1 + 4 * kRing) * kTile * sizeof(float);
}

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

struct Layout {
  size_t cum, dtf, cb, states, ent, bytes;
};

// elt: bytes of the inputs' type; f32 entering states overwrite the chunk
// states, bf16 ones get their own region
Layout layout(int B, const Dims& d, size_t elt) {
  Layout l;
  const size_t bhs = static_cast<size_t>(B) * d.H * d.S * sizeof(float);
  const size_t n_st = static_cast<size_t>(B) * d.H * d.nc * d.P * d.N;
  l.cum = 0;
  l.dtf = align256(bhs);
  l.cb = l.dtf + align256(bhs);
  l.states = l.cb + align256(static_cast<size_t>(B) * d.nc * d.Q * d.Q *
                             elt);
  l.ent = l.states + align256(n_st * sizeof(float));
  l.bytes = elt == sizeof(float) ? l.ent : l.ent + align256(n_st * elt);
  if (elt == sizeof(float)) l.ent = l.states;
  return l;
}

Dims dims(int S, int H, int P, int N, int Q) {
  Dims d{};
  d.S = S;
  d.H = H;
  d.P = P;
  d.N = N;
  d.Q = Q;
  d.nc = S / Q;
  d.nt = (Q + kTile - 1) / kTile;
  return d;
}

bool aligned4(const void* p, size_t elt) {
  return reinterpret_cast<uintptr_t>(p) % (4 * elt) == 0;
}

template <typename T>
int run(const void* x, const void* dt, const void* dtA, const void* Bm,
        const void* Cm, const void* s0, void* y, void* s_out, char* scratch,
        int B, const Dims& d0, cudaStream_t st, float* stage_ms) {
  const Layout l = layout(B, d0, sizeof(T));
  Dims d = d0;
  constexpr int kPer16 = 16 / sizeof(T);  // elements of 16 bytes
  d.vx16 = d.P % kPer16 == 0 && aligned4(x, 4);
  d.vc16 = d.N % kPer16 == 0 && aligned4(Bm, 4) && aligned4(Cm, 4);
  d.vq16 = d.Q % kPer16 == 0;
  float* cum = reinterpret_cast<float*>(scratch + l.cum);
  float* dtf = reinterpret_cast<float*>(scratch + l.dtf);
  T* cbs = reinterpret_cast<T*>(scratch + l.cb);
  float* states = reinterpret_cast<float*>(scratch + l.states);
  T* ent = reinterpret_cast<T*>(scratch + l.ent);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_cb<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(cb_smem<T>()));
  if (!err)
    err = cudaFuncSetAttribute(chunk_state<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(state_smem<T>()));
  if (!err)
    err = cudaFuncSetAttribute(chunk_out<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(out_smem<T>()));
  if (err) return static_cast<int>(err);
  cudaEvent_t ev[kKernels + 1];
  int n_ev = 0;
  auto mark = [&]() {
    if (stage_ms == nullptr) return;
    cudaEventCreate(&ev[n_ev]);
    cudaEventRecord(ev[n_ev++], st);
  };
  const long long chains = static_cast<long long>(B) * d.nc * d.H;
  mark();
  chunk_cumsum<T><<<static_cast<unsigned>((chains + kThreads - 1) / kThreads),
                    kThreads, 0, st>>>(static_cast<const T*>(dt),
                                       static_cast<const T*>(dtA), cum, dtf, d,
                                       chains);
  mark();
  chunk_cb<T><<<dim3(d.nt * (d.nt + 1) / 2, d.nc, B), kThreads, cb_smem<T>(),
                st>>>(static_cast<const T*>(Bm), static_cast<const T*>(Cm),
                      cbs, d);
  mark();
  chunk_state<T><<<dim3(d.H * d.nc, B), kThreads, state_smem<T>(), st>>>(
      static_cast<const T*>(x), dtf, static_cast<const T*>(Bm), cum, states,
      d);
  mark();
  state_pass<T><<<dim3((d.P * d.N + kThreads - 1) / kThreads, B * d.H),
                  kThreads, 0, st>>>(states, ent, cum,
                                     static_cast<const float*>(s0),
                                     static_cast<float*>(s_out), d);
  mark();
  chunk_out<T><<<dim3(d.nt * d.H * d.nc, B), kThreads, out_smem<T>(),
                 st>>>(static_cast<const T*>(x), dtf,
                       static_cast<const T*>(Cm), cbs, cum, ent,
                       static_cast<T*>(y), d);
  mark();
  err = cudaGetLastError();
  if (stage_ms != nullptr) {
    cudaEventSynchronize(ev[n_ev - 1]);
    for (int k = 0; k + 1 < n_ev; ++k)
      cudaEventElapsedTime(&stage_ms[k], ev[k], ev[k + 1]);
    for (int k = 0; k < n_ev; ++k) cudaEventDestroy(ev[k]);
    if (!err) err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

bool bad(int B, int S, int H, int P, int N, int Q) {
  return B < 1 || H < 1 || P < 1 || N < 1 || P > kPMax || N > kNMax ||
         Q < 1 || S < Q || S % Q != 0;
}

}  // namespace

// Bytes of scratch one call in `dtype` needs (cum, CB, chunk states and,
// for bf16, the entering states in bf16); -1 for
// shapes the kernels do not take.
extern "C" long long ssd_scan_scratch_bytes(int dtype, int B, int S, int H,
                                            int P, int N, int Q) {
  if (bad(B, S, H, P, N, Q) || dtype < 0 || dtype > 1) return -1;
  return static_cast<long long>(
      layout(B, dims(S, H, P, N, Q), dtype == 0 ? 4 : 2).bytes);
}

// dtype: 0 = float32, 1 = bfloat16 (x, dt, dtA, B, C and y share it).
// x, y (B, S, H, P); dt, dtA (B, S, H); Bm, Cm (B, S, N); s0 (B, H, P, N)
// f32 or NULL (zero start); s_out (B, H, P, N) f32; scratch of
// scratch_bytes >= ssd_scan_scratch_bytes(dtype, B, S, H, P, N, Q).  P <= 64,
// N <= 128, S a multiple of Q.  stage_ms null or 5 host floats for each
// kernel's time (the call then synchronises the stream).  Returns the
// first CUDA error of the launches.
extern "C" int ssd_scan(int dtype, const void* x, const void* dt,
                        const void* dtA, const void* Bm, const void* Cm,
                        const void* s0, void* y, void* s_out, void* scratch,
                        long long scratch_bytes, int B, int S, int H, int P,
                        int N, int Q, void* stage_ms, void* stream) {
  if (bad(B, S, H, P, N, Q)) return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = dims(S, H, P, N, Q);
  if (scratch == nullptr || dtype < 0 || dtype > 1 ||
      scratch_bytes <
          static_cast<long long>(layout(B, d, dtype == 0 ? 4 : 2).bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* sc = static_cast<char*>(scratch);
  float* ms = static_cast<float*>(stage_ms);
  if (dtype == 0)
    return run<float>(x, dt, dtA, Bm, Cm, s0, y, s_out, sc, B, d, st, ms);
  if (dtype == 1)
    return run<__nv_bfloat16>(x, dt, dtA, Bm, Cm, s0, y, s_out, sc, B, d, st,
                              ms);
  return static_cast<int>(cudaErrorInvalidValue);
}
