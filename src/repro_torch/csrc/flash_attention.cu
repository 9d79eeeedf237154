// Flash attention forward for the train step: causal, windowed or
// non-causal GQA attention with a logit softcap, writing the output and its
// log-sum-exp (the saved statistic of the backward).
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (the Pallas
// TPU kernel behind flash_attention, the TPU-native form of the contract
// that models/attention.py::flash_attention_jnp implements in XLA).
//
// What bounds it on an H100: operations.  Two products of 2*hd flops per
// (q row, key, head) pair, 4*B*H*Sq*Skv*hd in all, about halved by the
// causal mask: 68.7 GFLOP at the train shape (B=2, H=32, S=2048, hd=128),
// 0.07 ms at the dense bf16 tensor-core peak (989 TFLOP/s), against 33.5 MB
// of q/k/v/o (0.01 ms at 3.35 TB/s).  The bf16 products therefore run on
// the tensor cores (WMMA 16x16x16, f32 accumulation); the f32 variant,
// which only the parity checks use, keeps f32 products on the CUDA cores.
//
// Design: the TPU kernel ran an ordered grid whose innermost "arbitrary" kv
// axis carried the online-softmax state (m, l, acc) in VMEM scratch.
// Hopper blocks run in no order, so one block owns one (b, h, 64-row q
// tile) and loops over kv tiles itself, skipping tiles wholly above the
// diagonal (causal) or wholly left of the window.  Blocks are issued
// longest causal row range first.  q head h reads kv head h / (H/K) (GQA:
// k/v are never materialised per q head), and every tensor is addressed
// through the strides it is given, so the model hands the kernel
// transposed views of its (B, S, H, hd) tensors with no copy.  K and V
// tiles are staged in shared memory by all 128 threads (16-byte vector
// loads, rows past Skv zero-filled); after that every step is warp-local:
// warp w owns q rows 16w..16w+15 of the tile, computes their scores into
// shared memory, runs the online softmax on them (one row at a time, lanes
// over columns, shuffle reductions), rescales its rows of the f32
// accumulator (kept in shared memory, as WMMA fragments have no row
// layout) and adds P.V into them.  Rows past Sq are computed on zeros and
// not stored.
//
// Arithmetic follows the Pallas kernel: scale hd^-0.5 in f32 (folded into
// q for f32 inputs; applied to the exact bf16 products' f32 sums for bf16),
// softcap cap*tanh(s/cap) before the mask, masked scores set to the finite
// NEG_INF = -2e38 (a row whose first tile is wholly masked gets exp(0)
// terms that the next live tile's corr = exp(m_prev - m_new) = 0 wipes
// out, where -INFINITY would give NaN), the final division by max(l, 1e-37)
// and lse = m + log(max(l, 1e-37)).  For bf16 the probabilities enter the
// P.V product rounded to bf16 (l sums them in f32), as flash_attention_jnp
// does with p_bf16.  head_dim is 32, 64, 128 or 256.
#include <mma.h>

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileQ = 16 * kWarps;  // q rows per block, 16 per warp

constexpr size_t round128(size_t x) { return (x + 127) / 128 * 128; }

// Shared-memory layout of one block: q/k/v tiles (T), the warp's scores
// (f32), probabilities (T), the output accumulator (f32) and m, l, corr.
// Rows carry 16 bytes of padding against bank conflicts (and to keep WMMA
// row strides multiples of 16 bytes).  f32 at head_dim 256 takes 32-key
// tiles so that the block fits in the 227 KB a block may use.
template <typename T, int HD>
struct Layout {
  static constexpr int TK = (sizeof(T) == 4 && HD == 256) ? 32 : 64;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LDX = HD + PAD;  // q/k/v row stride, elements
  static constexpr int LDS = TK + 4;    // scores row stride, floats
  static constexpr int LDP = TK + PAD;  // probabilities row stride
  static constexpr int LDO = HD + 4;    // accumulator row stride, floats
  static constexpr size_t Q = 0;
  static constexpr size_t K = round128(Q + sizeof(T) * kTileQ * LDX);
  static constexpr size_t V = round128(K + sizeof(T) * TK * LDX);
  static constexpr size_t S = round128(V + sizeof(T) * TK * LDX);
  static constexpr size_t P = round128(S + sizeof(float) * kTileQ * LDS);
  static constexpr size_t O = round128(P + sizeof(T) * kTileQ * LDP);
  static constexpr size_t M = round128(O + sizeof(float) * kTileQ * LDO);
  static constexpr size_t bytes = M + sizeof(float) * 3 * kTileQ;
};

struct Strides {  // elements between (batch, head, position) neighbours
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// ROWS rows of HD elements from src (row r at src + (row0 + r) * stride)
// into dst (row stride LD), 16 bytes a thread; rows past nrows are zero.
// f32 values are multiplied by ``mul`` on the way (q's scale); bf16 values
// are copied as they are.
template <typename T, int HD, int ROWS, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          long long stride, int row0,
                                          int nrows, float mul) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = HD / VEC;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < nrows)
      val = *reinterpret_cast<const uint4*>(src + gr * stride + c);
    if constexpr (std::is_same<T, float>::value) {
      float* f = reinterpret_cast<float*>(&val);
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] *= mul;
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// Scores of the warp's 16 rows against the TK keys of the tile, into Ss.
// f32: CUDA-core FMAs, lanes over keys (q already scaled).
template <int HD, int TK>
__device__ __forceinline__ void scores(const float* Qs, const float* Ks,
                                       float* Ss, int warp, int lane) {
  using L = Layout<float, HD>;
  constexpr int NC = TK / 32;
  float acc[16][NC];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.f;
  const float* qrow = Qs + 16 * warp * L::LDX;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float kv[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) kv[j] = Ks[(lane + 32 * j) * L::LDX + d];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float qv = qrow[r * L::LDX + d];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] = fmaf(qv, kv[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j)
      Ss[(16 * warp + r) * L::LDS + lane + 32 * j] = acc[r][j];
}

// bf16: tensor cores, one 16x16 f32 fragment per 16 keys (unscaled sums).
template <int HD, int TK>
__device__ __forceinline__ void scores(const __nv_bfloat16* Qs,
                                       const __nv_bfloat16* Ks, float* Ss,
                                       int warp, int lane) {
  using namespace nvcuda;
  using L = Layout<__nv_bfloat16, HD>;
#pragma unroll
  for (int j = 0; j < TK / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int d = 0; d < HD; d += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> bk;  // K^T: element (d, c) = K[c][d]
      wmma::load_matrix_sync(a, Qs + 16 * warp * L::LDX + d, L::LDX);
      wmma::load_matrix_sync(bk, Ks + 16 * j * L::LDX + d, L::LDX);
      wmma::mma_sync(acc, a, bk, acc);
    }
    wmma::store_matrix_sync(Ss + 16 * warp * L::LDS + 16 * j, acc, L::LDS,
                            wmma::mem_row_major);
  }
}

// O[rows of the warp] += P . V over the tile's TK keys.
template <int HD, int TK>
__device__ __forceinline__ void add_pv(const float* Ps, const float* Vs,
                                       float* Os, int warp, int lane) {
  using L = Layout<float, HD>;
  constexpr int NPL = HD / 32;
  for (int r = 0; r < 16; ++r) {
    const int row = 16 * warp + r;
    float acc[NPL];
#pragma unroll
    for (int i = 0; i < NPL; ++i) acc[i] = Os[row * L::LDO + lane + 32 * i];
#pragma unroll 8
    for (int c = 0; c < TK; ++c) {
      const float p = Ps[row * L::LDP + c];
#pragma unroll
      for (int i = 0; i < NPL; ++i)
        acc[i] = fmaf(p, Vs[c * L::LDX + lane + 32 * i], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < NPL; ++i) Os[row * L::LDO + lane + 32 * i] = acc[i];
  }
}

template <int HD, int TK>
__device__ __forceinline__ void add_pv(const __nv_bfloat16* Ps,
                                       const __nv_bfloat16* Vs, float* Os,
                                       int warp, int lane) {
  using namespace nvcuda;
  using L = Layout<__nv_bfloat16, HD>;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      a[TK / 16];
#pragma unroll
  for (int c = 0; c < TK / 16; ++c)
    wmma::load_matrix_sync(a[c], Ps + 16 * warp * L::LDP + 16 * c, L::LDP);
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    float* optr = Os + 16 * warp * L::LDO + 16 * n;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, optr, L::LDO, wmma::mem_row_major);
#pragma unroll
    for (int c = 0; c < TK / 16; ++c) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bv;
      wmma::load_matrix_sync(bv, Vs + 16 * c * L::LDX + 16 * n, L::LDX);
      wmma::mma_sync(acc, a[c], bv, acc);
    }
    wmma::store_matrix_sync(optr, acc, L::LDO, wmma::mem_row_major);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse, int H, int K, int Sq,
                           int Skv, Strides st, int causal, int window,
                           float scale, float cap) {
  using L = Layout<T, HD>;
  constexpr int TK = L::TK;
  constexpr int NC = TK / 32;
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::Q);
  T* Ks = reinterpret_cast<T*>(smem + L::K);
  T* Vs = reinterpret_cast<T*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  T* Ps = reinterpret_cast<T*>(smem + L::P);
  float* Os = reinterpret_cast<float*>(smem + L::O);
  float* m_s = reinterpret_cast<float*>(smem + L::M);
  float* l_s = m_s + kTileQ;
  float* c_s = l_s + kTileQ;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTileQ;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* kbase = k + b * st.kb + kh * st.kh;
  const T* vbase = v + b * st.vb + kh * st.vh;

  load_tile<T, HD, kTileQ, L::LDX>(Qs, q + b * st.qb + h * st.qh, st.qs, q0,
                                   Sq, scale);
  for (int i = threadIdx.x; i < kTileQ * L::LDO; i += kThreads) Os[i] = 0.f;
  if (threadIdx.x < kTileQ) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }
  // live keys of the tile's rows: [k_lo, k_hi), rounded out to whole tiles
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Skv, q0 + kTileQ) : Skv;
  k_lo = k_lo / TK * TK;
  const float post = kF32 ? 1.f : scale;  // f32 q carries the scale
  __syncthreads();

  for (int k0 = k_lo; k0 < k_hi; k0 += TK) {
    load_tile<T, HD, TK, L::LDX>(Ks, kbase, st.ks, k0, Skv, 1.f);
    load_tile<T, HD, TK, L::LDX>(Vs, vbase, st.vs, k0, Skv, 1.f);
    __syncthreads();
    scores<HD, TK>(Qs, Ks, Ss, warp, lane);
    __syncwarp();
    // online softmax of the warp's rows; lanes over keys
    for (int r = 0; r < 16; ++r) {
      const int row = 16 * warp + r;
      const int qi = q0 + row;
      float s[NC];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = lane + 32 * j;
        const int kj = k0 + c;
        float x = Ss[row * L::LDS + c] * post;
        if (cap != 0.f) x = cap * tanhf(x / cap);
        bool ok = kj < Skv;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && kj > qi - window;
        s[j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[j]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float p = expf(s[j] - m_new);
        sum += p;
        Ps[row * L::LDP + lane + 32 * j] = from_f32<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[row] = l_s[row] * corr + sum;
        m_s[row] = m_new;
        c_s[row] = corr;
      }
    }
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int row = 16 * warp + r;
      const float corr = c_s[row];
      for (int n = lane; n < HD; n += 32) Os[row * L::LDO + n] *= corr;
    }
    __syncwarp();
    add_pv<HD, TK>(Ps, Vs, Os, warp, lane);
    __syncthreads();  // the next tile overwrites Ks and Vs
  }

  for (int r = 0; r < 16; ++r) {
    const int row = 16 * warp + r;
    const int qi = q0 + row;
    if (qi >= Sq) break;
    const float denom = fmaxf(l_s[row], 1e-37f);
    T* orow = o + b * st.ob + h * st.oh + qi * st.os;
    for (int n = lane; n < HD; n += 32)
      orow[n] = from_f32<T>(Os[row * L::LDO + n] / denom);
    if (lane == 0)
      lse[((size_t)b * H + h) * Sq + qi] = m_s[row] + logf(denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int K, int Sq, int Skv, int hd, const Strides& st,
           int causal, int window, float scale, float cap,
           cudaStream_t stream) {
  return launch_for_head_dim(hd, [&](auto npl) {
    constexpr int HD = 32 * decltype(npl)::value;
    auto kern = flash_attention_kernel<T, HD>;
    const size_t bytes = Layout<T, HD>::bytes;
    if (cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes)) != cudaSuccess)
      return;  // the error stays for cudaGetLastError
    const dim3 grid((Sq + kTileQ - 1) / kTileQ, H, B);
    kern<<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), H, K, Sq, Skv, st, causal, window, scale,
        cap);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {32, 64, 128, 256}.  q (B,H,Sq,hd),
// k/v (B,K,Skv,hd) and o (B,H,Sq,hd) are addressed through their (batch,
// head, position) strides in elements, the last dimension contiguous; lse is
// a contiguous (B,H,Sq) f32.  window <= 0 is global.  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* o, void* lse, int B,
                               int H, int K, int Sq, int Skv, int hd,
                               long long qb, long long qh, long long qs,
                               long long kb, long long kh, long long ks,
                               long long vb, long long vh, long long vs,
                               long long ob, long long oh, long long os,
                               int causal, int window, float scale, float cap,
                               void* stream) {
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, lse, B, H, K, Sq, Skv, hd, st, causal,
                         window, scale, cap, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, lse, B, H, K, Sq, Skv, hd, st,
                                 causal, window, scale, cap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
