// Mamba-2 SSD chunked scan: one block per (batch, head) walks the chunks in
// order and carries the (P, N) float32 state in shared memory.
//
// Replaces: src/repro/kernels/ssd_scan.py::_ssd_kernel (the Pallas TPU kernel
// behind ssd_scan), and adds what the model's caller needs: an optional f32
// initial state and the final state as a second output.
//
// Per chunk of Q rows (cum = inclusive cumsum of dtA over the chunk):
//   y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//       + exp(cum_i) (C_i . s)
//   s   = exp(cum_Q) s + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T
// in float32, y stored in the inputs' type.
//
// What bounds it on an H100: operations.  At mamba2-1.3b's prefill shape
// (B=4, S=2048, H=64, P=64, N=128, Q=256) the inputs and outputs are ~150 MB
// (~45 us at 3.35 TB/s) while the chunk products are ~35 GFLOP (~0.52 ms at
// the 67 TFLOP/s float32 rate outside the tensor cores).
//
// Design: the TPU kernel kept a whole (Q, N) chunk of B and C in VMEM; at
// Q = 256 one f32 copy of each is 128 KB, over the 227 KB a block may have.
// Here the chunk is cut into 64-row tiles: for every row tile i the block
// holds C_i (64 x N), forms the C_i . s term, then for every column tile
// j <= i loads B_j and x_j, forms the 64 x 64 weights (C_i . B_j) *
// exp(cum_i - cum_j) * dt_j only where j <= i (so exp never sees a positive
// argument), and accumulates the weights times x_j.  The state update runs
// after every row tile of the chunk has read the old state.  256 threads
// each own a 4 x 4 register tile of every 64 x 64 product (4 x 8 of the
// 64 x 128 state update); N-wide rows are padded to N + 1 floats so that
// the threads of a warp read distinct banks.  C . B^T is recomputed by every
// head (the TPU kernel did the same); products stay on the CUDA cores in
// float32.  Shared memory: 3 x 64 x 129 + 64 x 65 + 64 x 64 + 2 Q floats
// (134 KB at Q = 256), so one block runs per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;           // rows of a row or column tile
constexpr int kPMax = 64;           // head dim P the block covers
constexpr int kNMax = 128;          // state dim N the block covers
constexpr int kLd = kNMax + 1;      // padded row stride of N-wide tiles
constexpr int kGd = kTile + 1;      // padded row stride of the weights
constexpr int kThreads = 256;       // 16 x 16

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

// rows [row0, row0 + kTile) of a (b, S, N) matrix into dst[kTile][kLd] as
// f32; rows at or past `valid` and columns at or past N are zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          size_t row0, int valid, int N) {
  for (int e = threadIdx.x; e < kTile * kNMax; e += kThreads) {
    const int r = e / kNMax, n = e % kNMax;
    dst[r * kLd + n] =
        (r < valid && n < N)
            ? to_f32(src[(row0 + r) * static_cast<size_t>(N) + n])
            : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const T* __restrict__ dtA, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ s0,
                    T* __restrict__ y, float* __restrict__ s_out, int S, int H,
                    int P, int N, int Q) {
  extern __shared__ float smem[];
  float* s_sh = smem;                    // [kPMax][kLd] carried state
  float* c_sh = s_sh + kPMax * kLd;      // [kTile][kLd] C rows of tile i
  float* b_sh = c_sh + kTile * kLd;      // [kTile][kLd] B rows of tile j
  float* g_sh = b_sh + kTile * kLd;      // [kTile][kGd] weights (i, j)
  float* x_sh = g_sh + kTile * kGd;      // [kTile][kPMax] x rows of tile j
  float* cum = x_sh + kTile * kPMax;     // [Q] cumsum of dtA over the chunk
  float* dts = cum + Q;                  // [Q] dt over the chunk

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  for (int e = threadIdx.x; e < kPMax * kNMax; e += kThreads) {
    const int p = e / kNMax, n = e - p * kNMax;
    s_sh[p * kLd + n] = (s0 != nullptr && p < P && n < N)
                            ? s0[(static_cast<size_t>(bh) * P + p) * N + n]
                            : 0.f;
  }
  const int nt = (Q + kTile - 1) / kTile;
  // x, y rows are (b, t, h, :); dt, dtA entries (b, t, h)
  auto xrow = [&](int t) {
    return (static_cast<size_t>(b) * S + t) * H + h;
  };

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();                     // the previous chunk is done
    for (int i = threadIdx.x; i < Q; i += kThreads) {
      cum[i] = to_f32(dtA[xrow(c0 + i)]);
      dts[i] = to_f32(dt[xrow(c0 + i)]);
    }
    __syncthreads();
    if (threadIdx.x == 0) {              // sequential, as jnp.cumsum on a CPU
      float acc = 0.f;
      for (int i = 0; i < Q; ++i) {
        acc += cum[i];
        cum[i] = acc;
      }
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];

    for (int it = 0; it < nt; ++it) {
      const int i0 = it * kTile;
      load_rows(c_sh, Cm, static_cast<size_t>(b) * S + c0 + i0,
                min(kTile, Q - i0), N);
      __syncthreads();
      float acc[4][4];
      // inter-chunk term: exp(cum_i) * (C_i . s_p)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = c_sh[(ty + 16 * r) * kLd + n];
#pragma unroll
        for (int q = 0; q < 4; ++q) sv[q] = s_sh[(tx + 16 * q) * kLd + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(cv[r], sv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const float e = i < Q ? expf(cum[i]) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] *= e;
      }
      // intra-chunk term over column tiles j <= i
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        const int jv = min(kTile, Q - j0);
        __syncthreads();                 // b_sh, x_sh, g_sh free again
        load_rows(b_sh, Bm, static_cast<size_t>(b) * S + c0 + j0, jv, N);
        for (int e = threadIdx.x; e < kTile * kPMax; e += kThreads) {
          const int j = e / kPMax, p = e - j * kPMax;
          x_sh[e] = (j < jv && p < P)
                        ? to_f32(x[xrow(c0 + j0 + j) * P + p])
                        : 0.f;
        }
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) g[r][q] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = c_sh[(ty + 16 * r) * kLd + n];
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = b_sh[(tx + 16 * q) * kLd + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) g[r][q] = fmaf(cv[r], bv[q], g[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + tx + 16 * q;
            // only j <= i: exp(cum_i - cum_j) of a positive argument is never
            // formed (the jnp version forms it and masks it after)
            g_sh[(ty + 16 * r) * kGd + tx + 16 * q] =
                (i < Q && j <= i) ? g[r][q] * expf(cum[i] - cum[j]) * dts[j]
                                  : 0.f;
          }
        }
        __syncthreads();
        for (int j = 0; j < kTile; ++j) {
          float gv[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) gv[r] = g_sh[(ty + 16 * r) * kGd + j];
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[q] = x_sh[j * kPMax + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(gv[r], xv[q], acc[r][q]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= Q) continue;
        T* yrow = y + xrow(c0 + i) * P;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx + 16 * q;
          if (p < P) yrow[p] = from_f32<T>(acc[r][q]);
        }
      }
      __syncthreads();                   // c_sh is reloaded next
    }

    // state update: s = exp(cum_Q) s + sum_j (exp(cum_Q - cum_j) dt_j x_j) B_j
    float sa[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) sa[r][q] = 0.f;
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * kTile;
      const int jv = min(kTile, Q - j0);
      __syncthreads();
      load_rows(b_sh, Bm, static_cast<size_t>(b) * S + c0 + j0, jv, N);
      for (int e = threadIdx.x; e < kTile * kPMax; e += kThreads) {
        const int j = e / kPMax, p = e - j * kPMax;
        float v = 0.f;
        if (j < jv && p < P) {
          const float w = expf(cum_last - cum[j0 + j]) * dts[j0 + j];
          v = to_f32(x[xrow(c0 + j0 + j) * P + p]) * w;
        }
        x_sh[e] = v;
      }
      __syncthreads();
      for (int j = 0; j < kTile; ++j) {
        float xv[4], bv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) xv[r] = x_sh[j * kPMax + ty + 16 * r];
#pragma unroll
        for (int q = 0; q < 8; ++q) bv[q] = b_sh[j * kLd + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) sa[r][q] = fmaf(xv[r], bv[q], sa[r][q]);
      }
    }
    __syncthreads();
    const float decay = expf(cum_last);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float* sp = s_sh + (ty + 16 * r) * kLd + tx + 16 * q;
        *sp = *sp * decay + sa[r][q];
      }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    s_out[static_cast<size_t>(bh) * P * N + e] = s_sh[p * kLd + n];
  }
}

size_t smem_bytes(int Q) {
  return sizeof(float) *
         (static_cast<size_t>(kPMax) * kLd + 2 * kTile * kLd + kTile * kGd +
          kTile * kPMax + 2 * static_cast<size_t>(Q));
}

template <typename T>
int launch(const void* x, const void* dt, const void* dtA, const void* Bm,
           const void* Cm, const void* s0, void* y, void* s_out, int Bsz,
           int S, int H, int P, int N, int Q, cudaStream_t stream) {
  const size_t bytes = smem_bytes(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<Bsz * H, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(dtA), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_out), S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dt, dtA, B, C and y share it).
// x, y (B, S, H, P); dt, dtA (B, S, H); Bm, Cm (B, S, N); s0 (B, H, P, N)
// f32 or NULL (zero start); s_out (B, H, P, N) f32.  P <= 64, N <= 128,
// S a multiple of Q.  Returns the CUDA error of the launch.
extern "C" int ssd_scan(int dtype, const void* x, const void* dt,
                        const void* dtA, const void* Bm, const void* Cm,
                        const void* s0, void* y, void* s_out, int B, int S,
                        int H, int P, int N, int Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P > kPMax || N > kNMax || Q < 1 || S % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(x, dt, dtA, Bm, Cm, s0, y, s_out, B, S, H, P, N, Q,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, dtA, Bm, Cm, s0, y, s_out, B, S, H, P,
                                 N, Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
