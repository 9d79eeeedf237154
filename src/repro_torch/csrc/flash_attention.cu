// Flash attention forward for the train step, the dense prefill and the
// scalar-position decode: causal, windowed or non-causal GQA attention with
// a logit softcap, writing the output and its log-sum-exp (the saved
// statistic of the backward).  Query row i sits at position q_offset + i
// and only keys below kv_len are live: key j is read by row i when j <
// kv_len, j <= q_offset + i (causal) and j > q_offset + i - window (window
// > 0).  The TPU kernel has neither argument (it ran at q_offset 0 and
// kv_len Skv); flash_attention_jnp took them under its custom VJP, and a
// decode step (Sq = 1, q_offset = pos, kv_len = pos + 1) or a later chunk
// of a prompt needs them.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (the Pallas
// TPU kernel behind flash_attention, the TPU-native form of the contract
// that models/attention.py::flash_attention_jnp implements in XLA).
//
// What bounds it on an H100: operations.  Two products of 2*hd flops per
// live (q row, key, head) pair, 4*B*H*Sq*Skv*hd in all, about halved by the
// causal mask: 68.7 GFLOP at the train shape (B=2, H=32, S=2048, hd=128),
// 0.07 ms at the dense bf16 tensor-core peak (989 TFLOP/s), against 33.5 MB
// of q/k/v/o (0.01 ms at 3.35 TB/s).  Only wgmma reaches that peak, and
// only if the loads overlap the products and the softmax stays out of
// shared memory.
//
// Design (bf16): the TPU kernel ran an ordered grid whose innermost
// "arbitrary" kv axis carried the online-softmax state (m, l, acc) in VMEM
// scratch.  Hopper blocks run in no order, so one block owns one (b, h,
// 128-row q tile) and loops over kv tiles itself, skipping tiles wholly
// above the diagonal (causal) or wholly left of the window; the q tile is
// the slowest grid axis, issued longest causal row range first; the tile
// range starts at the window's first key and stops at kv_len (and, causal,
// at the tile's last row's position), so no tile past kv_len is loaded or
// multiplied.  A block
// is warp specialised: one producer warpgroup (one thread of it issues the
// copies) and two consumer warpgroups of 64 q rows each, with setmaxnreg
// moving registers from the producer to the consumers.  The producer loads
// Q once and keeps K and V tiles of TK keys in flight in a ring of two
// stages through TMA, each guarded by "full" mbarriers completed by the
// copies' byte counts and "empty" mbarriers, one arrival per consumer warp,
// K and V apart (K is free once S is, V once P.V is).  The tensor maps are
// built on the host per call over the (hd, position, head, batch) extents
// and strides, so the model's transposed (B, S, H, hd) views go in with no
// copy, q head h reads kv head h / (H/K) by coordinate (GQA), and TMA's
// zero fill past Sq and Skv replaces explicit zeroing.  Tiles are loaded as
// panels of PW = 64, 32 or 16 columns (128-, 64- or 32-byte rows, swizzled
// to match: hd 128 and 256 as 64-column panels, hd 96 as three 32-column
// ones, hd 16 as one), and the wgmma shared-memory descriptors carry the
// same swizzle.  A consumer warpgroup computes S = Q.K^T as one wgmma
// m64nTKk16 a 16-column step, from shared memory into registers, then the
// scale, softcap and masks (masks only on tiles that straddle the
// diagonal, the window's edge or kv_len) and the online softmax in
// registers: in the accumulator's layout a thread holds rows 16w + lane/4
// and +8, so
// a row's max and sum need two shuffles in its quad.  P, rounded to bf16
// in registers, is already in the layout of a wgmma A operand, so O += P.V
// is one wgmma m64nHDk16 a 16-key step with P from registers and V from
// shared memory through the transpose bit; O stays in registers across all
// kv tiles.  The products of tile j overlap the softmax twice over: a
// warpgroup issues S_j together with P_{j-1}.V_{j-1} and runs the softmax
// of S_j while the latter runs, and the two warpgroups take turns to issue
// (named barriers), so that one's softmax runs while the other's products
// do.  Rows past Sq are not stored.
//
// The f32 variant, used only by the parity checks, keeps f32 products on
// the CUDA cores (TF32 cannot hold 2e-5): one block per (b, h, 64-row q
// tile), K and V tiles staged in shared memory by all threads, warp w owning
// q rows 16w..16w+15 (scores, softmax one row at a time, accumulator in
// shared memory).  With p_bf16 it rounds each probability to bf16 before
// P.V and sums l from the unrounded ones, the bf16 variant's arithmetic
// (flash_attention_jnp's p_bf16).
//
// Arithmetic follows the Pallas kernel: scale hd^-0.5 in f32 (folded into
// q for f32 inputs; applied to the exact bf16 products' f32 sums for bf16),
// softcap cap*tanh(s/cap) before the mask, masked scores set to the finite
// NEG_INF = -2e38 (a row whose first tile is wholly masked gets exp(0)
// terms that the next live tile's corr = exp(m_prev - m_new) = 0 wipes
// out, where -INFINITY would give NaN; the range never holds a tile wholly
// past kv_len, and a query row with no live key at all is refused by the
// wrapper), the final division by max(l, 1e-37)
// and lse = m + log(max(l, 1e-37)).  For bf16 the softmax runs in base 2
// (scores times log2 e, ex2.approx), the probabilities enter the P.V
// product rounded to bf16 and l sums them in f32, as flash_attention_jnp
// does with p_bf16.  head_dim is 16, 32, 64, 96, 128 or 256.
#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's types

#include <cstdint>

#include "attention_common.cuh"

namespace {

struct Strides {  // elements between (batch, head, position) neighbours
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// ------------------------------------------------------------------ f32

namespace f32 {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileQ = 16 * kWarps;  // q rows per block, 16 per warp

constexpr size_t round128(size_t x) { return (x + 127) / 128 * 128; }

// Shared-memory layout of one block: q/k/v tiles, the warps' scores and
// probabilities, the output accumulator and m, l, corr.  Rows carry 16
// bytes of padding against bank conflicts.  hd 256 takes 32-key tiles so
// that the block fits in the 227 KB a block may use.
template <int HD>
struct Layout {
  static constexpr int TK = HD == 256 ? 32 : 64;
  static constexpr int LDX = HD + 4;  // q/k/v row stride, floats
  static constexpr int LDS = TK + 4;  // scores and probabilities
  static constexpr int LDO = HD + 4;  // accumulator
  static constexpr size_t Q = 0;
  static constexpr size_t K = round128(Q + sizeof(float) * kTileQ * LDX);
  static constexpr size_t V = round128(K + sizeof(float) * TK * LDX);
  static constexpr size_t S = round128(V + sizeof(float) * TK * LDX);
  static constexpr size_t P = round128(S + sizeof(float) * kTileQ * LDS);
  static constexpr size_t O = round128(P + sizeof(float) * kTileQ * LDS);
  static constexpr size_t M = round128(O + sizeof(float) * kTileQ * LDO);
  static constexpr size_t bytes = M + sizeof(float) * 3 * kTileQ;
};

// ROWS rows of HD floats from src (row r at src + (row0 + r) * stride) into
// dst (row stride LD), 16 bytes a thread, times ``mul``; rows past nrows
// are zero.
template <int HD, int ROWS, int LD>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          long long stride, int row0,
                                          int nrows, float mul) {
  constexpr int PER_ROW = HD / 4;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 4;
    const int gr = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < nrows)
      val = *reinterpret_cast<const float4*>(src + gr * stride + c);
    val.x *= mul, val.y *= mul, val.z *= mul, val.w *= mul;
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

// Scores of the warp's 16 rows against the TK keys of the tile, into Ss;
// lanes over keys (q already scaled).
template <int HD>
__device__ __forceinline__ void scores(const float* Qs, const float* Ks,
                                       float* Ss, int warp, int lane) {
  using L = Layout<HD>;
  constexpr int NC = L::TK / 32;
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

// O[rows of the warp] += P . V over the tile's TK keys; lanes over hd
// columns lane, lane + 32, ... (hd 16 idles lanes 16-31).
template <int HD>
__device__ __forceinline__ void add_pv(const float* Ps, const float* Vs,
                                       float* Os, int warp, int lane) {
  using L = Layout<HD>;
  constexpr int NPL = (HD + 31) / 32;
  for (int r = 0; r < 16; ++r) {
    const int row = 16 * warp + r;
    float acc[NPL];
#pragma unroll
    for (int i = 0; i < NPL; ++i)
      acc[i] = lane + 32 * i < HD ? Os[row * L::LDO + lane + 32 * i] : 0.f;
#pragma unroll 8
    for (int c = 0; c < L::TK; ++c) {
      const float p = Ps[row * L::LDS + c];
#pragma unroll
      for (int i = 0; i < NPL; ++i)
        if (lane + 32 * i < HD)
          acc[i] = fmaf(p, Vs[c * L::LDX + lane + 32 * i], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < NPL; ++i)
      if (lane + 32 * i < HD) Os[row * L::LDO + lane + 32 * i] = acc[i];
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int K, int Sq, int Skv,
                     Strides st, int causal, int window, int q_off,
                     int kv_len, int p_bf16, float scale, float cap) {
  using L = Layout<HD>;
  constexpr int TK = L::TK;
  constexpr int NC = TK / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::Q);
  float* Ks = reinterpret_cast<float*>(smem + L::K);
  float* Vs = reinterpret_cast<float*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  float* Ps = reinterpret_cast<float*>(smem + L::P);
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
  const float* kbase = k + b * st.kb + kh * st.kh;
  const float* vbase = v + b * st.vb + kh * st.vh;

  load_tile<HD, kTileQ, L::LDX>(Qs, q + b * st.qb + h * st.qh, st.qs, q0,
                                Sq, scale);
  for (int i = threadIdx.x; i < kTileQ * L::LDO; i += kThreads) Os[i] = 0.f;
  if (threadIdx.x < kTileQ) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }
  // live keys of the tile's rows (positions q_off + q0 ..): [k_lo, k_hi),
  // k_lo rounded down to a whole tile
  int k_lo = window > 0 ? max(0, q_off + q0 - window + 1) : 0;
  const int k_hi = causal ? min(kv_len, q_off + q0 + kTileQ) : kv_len;
  k_lo = k_lo / TK * TK;
  __syncthreads();

  for (int k0 = k_lo; k0 < k_hi; k0 += TK) {
    load_tile<HD, TK, L::LDX>(Ks, kbase, st.ks, k0, Skv, 1.f);
    load_tile<HD, TK, L::LDX>(Vs, vbase, st.vs, k0, Skv, 1.f);
    __syncthreads();
    scores<HD>(Qs, Ks, Ss, warp, lane);
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
        float x = Ss[row * L::LDS + c];
        if (cap != 0.f) x = cap * tanhf(x / cap);
        bool ok = kj < kv_len;
        if (causal) ok = ok && kj <= q_off + qi;
        if (window > 0) ok = ok && kj > q_off + qi - window;
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
        Ps[row * L::LDS + lane + 32 * j] =
            p_bf16 ? __bfloat162float(__float2bfloat16_rn(p)) : p;
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
    add_pv<HD>(Ps, Vs, Os, warp, lane);
    __syncthreads();  // the next tile overwrites Ks and Vs
  }

  for (int r = 0; r < 16; ++r) {
    const int row = 16 * warp + r;
    const int qi = q0 + row;
    if (qi >= Sq) break;
    const float denom = fmaxf(l_s[row], 1e-37f);
    float* orow = o + b * st.ob + h * st.oh + qi * st.os;
    for (int n = lane; n < HD; n += 32) orow[n] = Os[row * L::LDO + n] / denom;
    if (lane == 0)
      lse[((size_t)b * H + h) * Sq + qi] = m_s[row] + logf(denom);
  }
}

}  // namespace f32

// ----------------------------------------------------------------- bf16

namespace bf16 {

constexpr int kStages = 2;
constexpr int kConsumerWarps = 8;  // warpgroups 1 and 2, 64 q rows each
constexpr int kThreads = 128 + 32 * kConsumerWarps;  // + the producer's
constexpr int kTileQ = 128;
// setmaxnreg: 168 registers a thread at launch (384 threads, one block an
// SM); the producer gives up 144 of them, which lets both consumer
// warpgroups rise to 240 (24 + 2 * 240 = 3 * 168).
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Tile geometry for head_dim HD: panels of PW columns (W-byte rows, the
// TMA box's inner extent and its swizzle span), TK keys a kv tile (64 at
// hd 256, where O takes 128 registers a thread and a stage 64 KB), and the
// shared-memory offsets from a 1024-byte aligned base (the swizzle
// pattern's period).
template <int HD>
struct Tiles {
  static constexpr int PW = HD % 64 == 0 ? 64 : (HD % 32 == 0 ? 32 : 16);
  static constexpr int W = 2 * PW;
  static constexpr int NP = HD / PW;
  static constexpr int TK = HD > 128 ? 64 : 128;
  static constexpr uint64_t kSwizzle = W == 128 ? 1 : (W == 64 ? 2 : 3);
  static constexpr uint32_t kQPanel = kTileQ * W;
  static constexpr uint32_t kKVPanel = TK * W;
  static constexpr uint32_t kQBytes = NP * kQPanel;
  static constexpr uint32_t kKVBytes = NP * kKVPanel;  // K or V, one stage
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKVBytes;
  static constexpr uint32_t kBar = kV + kStages * kKVBytes;
  static constexpr uint32_t kSmem = kBar + 8 * (1 + 4 * kStages) + 1024;
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

// Returns once the phase of parity ``parity`` has completed.
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

// One box of the 4-D tensor map at (column, position, head, batch) into
// shared memory at dst; completion is counted in bytes on ``bar``.
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

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode of the panel it points into.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (swizzle << 62);
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

// Keeps the compiler from moving accesses of accumulator registers across
// an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N f32) += A (64 x 16) . B (N x 16)^T, A and B in shared memory,
// both K-major (hd contiguous); scale_d = 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N f32) += A (64 x 16, bf16 in registers) . B (16 x N), B in shared
// memory N-major (the transpose bit: V's rows are keys, hd contiguous), N
// spanning one or more swizzle panels LBO bytes apart.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_bf16_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int H, int K, int Sq, int Skv, long long ob,
    long long oh, long long os, int causal, int window, int q_off, int kv_len,
    float scale, float cap) {
  using Tl = Tiles<HD>;
  constexpr int TK = Tl::TK, PW = Tl::PW, W = Tl::W, NP = Tl::NP;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + Tl::kK, sV = base + Tl::kV;
  const uint32_t bar_q = base + Tl::kBar;
  auto full_k = [&](int s) { return bar_q + 8 * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8 * (1 + kStages + s); };
  auto empty_k = [&](int s) { return bar_q + 8 * (1 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bar_q + 8 * (1 + 3 * kStages + s); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTileQ;  // longest first
  const int kh = h / (H / K);
  // live keys of the tile's rows (positions q_off + q0 ..): [k_lo, k_hi),
  // k_lo rounded down to a whole tile; the maps keep their Skv extents
  const int k_lo =
      (window > 0 ? max(0, q_off + q0 - window + 1) : 0) / TK * TK;
  const int k_hi = causal ? min(kv_len, q_off + q0 + kTileQ) : kv_len;
  const int ntiles = (k_hi - k_lo + TK - 1) / TK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), kConsumerWarps);
      mbar_init(empty_v(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one thread loads Q once, then K and V tiles
    // through the stage ring (a stage's K and V are released apart)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, Tl::kQBytes);
      for (int p = 0; p < NP; ++p)
        tma_load(sQ + p * Tl::kQPanel, &qmap, bar_q, p * PW, q0, h, b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        const uint32_t free_ph = ((j / kStages) & 1) ^ 1;  // round 0 passes
        const int k0 = k_lo + j * TK;
        mbar_wait(empty_k(s), free_ph);
        mbar_expect_tx(full_k(s), Tl::kKVBytes);
        for (int p = 0; p < NP; ++p)
          tma_load(sK + s * Tl::kKVBytes + p * Tl::kKVPanel, &kmap,
                   full_k(s), p * PW, k0, kh, b);
        mbar_wait(empty_v(s), free_ph);
        mbar_expect_tx(full_v(s), Tl::kKVBytes);
        for (int p = 0; p < NP; ++p)
          tma_load(sV + s * Tl::kKVBytes + p * Tl::kKVPanel, &vmap,
                   full_v(s), p * PW, k0, kh, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg + 1 owns q rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    const int wg = (warp >> 2) - 1;
    const int rbase = q0 + 64 * wg;
    const int r0 = rbase + 16 * (warp & 3) + (lane >> 2);  // and r0 + 8
    const int r1 = r0 + 8;
    const int tq = lane & 3;
    const float sl2 = scale * kLog2e;
    float oacc[HD / 2];  // O, one m64nHD accumulator
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
    float sc[TK / 2];  // S, then P, one m64nTK accumulator
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) sc[i] = 0.f;  // then scale_d 0 overwrites
    uint32_t pa[TK / 16][4];
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // base 2
    float corr0 = 1.f, corr1 = 1.f;

    // S = Q . K^T of the tile in stage s, issued (not waited for)
    auto issue_s = [&](int s) {
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = ((kk * 16) % PW) * 2;  // bytes into the panel
        const uint64_t da =
            desc(sQ + (kk * 16 / PW) * Tl::kQPanel + wg * 64 * W + col, 16,
                 8 * W, Tl::kSwizzle);
        const uint64_t db =
            desc(sK + s * Tl::kKVBytes + (kk * 16 / PW) * Tl::kKVPanel + col,
                 16, 8 * W, Tl::kSwizzle);
        wgmma_ss<TK>(sc, da, db, kk > 0);
      }
      wgmma_commit();
    };
    // O += P . V of the tile in stage s, issued (not waited for)
    auto issue_pv = [&](int s) {
      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma_rs<HD>(oacc, pa[kk],
                     desc(sV + s * Tl::kKVBytes + kk * 16 * W, Tl::kKVPanel,
                          8 * W, Tl::kSwizzle));
      wgmma_commit();
    };
    // scale, softcap and masks of the scores of the tile at k0, into base
    // 2 (masks only where a tile straddles the diagonal, the window's edge
    // or kv_len), then the online softmax: m, l, corr, and sc = exp2(s - m)
    auto softmax = [&](int k0) {
      fence_regs(sc);
      const bool edge = k0 + TK > kv_len ||
                        (causal && k0 + TK - 1 > q_off + rbase) ||
                        (window > 0 && k0 <= q_off + rbase + 63 - window);
      if (cap != 0.f) {
#pragma unroll
        for (int i = 0; i < TK / 2; ++i)
          sc[i] = cap * tanhf(sc[i] * scale / cap) * kLog2e;
      } else {
#pragma unroll
        for (int i = 0; i < TK / 2; ++i) sc[i] *= sl2;
      }
      if (edge) {
#pragma unroll
        for (int i = 0; i < TK / 2; ++i) {
          const int key = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
          const int row = (i & 2) ? r1 : r0;
          bool ok = key < kv_len;
          if (causal) ok = ok && key <= q_off + row;
          if (window > 0) ok = ok && key > q_off + row - window;
          sc[i] = ok ? sc[i] : kNegInf;
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < TK / 2; ++i) {
        if (i & 2)
          mx1 = fmaxf(mx1, sc[i]);
        else
          mx0 = fmaxf(mx0, sc[i]);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      corr0 = ex2(m0 - mx0);
      corr1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < TK / 2; ++i) {
        const float e = ex2(sc[i] - ((i & 2) ? m1 : m0));
        sc[i] = e;
        if (i & 2)
          sum1 += e;
        else
          sum0 += e;
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
    };
    // P in bf16, in the layout of a wgmma A operand: keys 16 kk .. + 15 are
    // accumulator registers 8 kk .. + 7
    auto make_p = [&]() {
#pragma unroll
      for (int i = 0; i < TK / 2; i += 2)
        pa[i / 8][(i % 8) / 2] = pack_bf16(sc[i], sc[i + 1]);
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // The two warpgroups take turns to issue their products (named barriers
    // 1 and 2), so that one's softmax runs while the other's wgmma do;
    // warpgroup 1 lets warpgroup 0 go first, and skips its last hand-over,
    // which nothing would wait for.
    auto my_turn = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
    };
    auto their_turn = [&](int j) {
      if (wg == 0 || j < ntiles - 1)
        asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
    };
    if (wg == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");

    mbar_wait(bar_q, 0);
    // tile 0: S alone
    mbar_wait(full_k(0), 0);
    my_turn();
    issue_s(0);
    their_turn(0);
    wgmma_wait_all();
    release(empty_k(0));
    softmax(k_lo);
    make_p();
    // tile j: S_j is issued with P_{j-1}.V_{j-1}, and its softmax runs
    // while that product does
    for (int j = 1; j < ntiles; ++j) {
      const int s = j % kStages, sp = (j - 1) % kStages;
      mbar_wait(full_k(s), (j / kStages) & 1);
      my_turn();
      issue_s(s);
      mbar_wait(full_v(sp), ((j - 1) / kStages) & 1);
      issue_pv(sp);
      their_turn(j);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      release(empty_k(s));
      softmax(k_lo + j * TK);
      wgmma_wait_all();
      fence_regs(oacc);
      release(empty_v(sp));
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) oacc[i] *= (i & 2) ? corr1 : corr0;
      make_p();
    }
    const int sl = (ntiles - 1) % kStages;
    mbar_wait(full_v(sl), ((ntiles - 1) / kStages) & 1);
    issue_pv(sl);
    wgmma_wait_all();
    fence_regs(oacc);
    release(empty_v(sl));

    // epilogue: the quad's partial sums, then o and lse of rows < Sq
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-37f), d1 = fmaxf(l1, 1e-37f);
    __nv_bfloat16* o0 = o + b * ob + h * oh + r0 * os;
    __nv_bfloat16* o1 = o + b * ob + h * oh + r1 * os;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int col = 8 * i + 2 * tq;
      if (r0 < Sq)
        *reinterpret_cast<uint32_t*>(o0 + col) =
            pack_bf16(oacc[4 * i] / d0, oacc[4 * i + 1] / d0);
      if (r1 < Sq)
        *reinterpret_cast<uint32_t*>(o1 + col) =
            pack_bf16(oacc[4 * i + 2] / d1, oacc[4 * i + 3] / d1);
    }
    if (tq == 0) {
      float* lrow = lse + ((size_t)b * H + h) * Sq;
      if (r0 < Sq) lrow[r0] = m0 * kLn2 + logf(d0);
      if (r1 < Sq) lrow[r1] = m1 * kLn2 + logf(d1);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 (hd, rows, heads, batch) tensor map with element strides (rs, hs,
// bs), boxes of PW columns x box_rows positions, swizzled to the panel's
// row bytes.  Returns false if the driver refuses it.
bool make_map(CUtensorMap* map, const void* ptr, int hd, int rows, int heads,
              int batch, long long rs, long long hs, long long bs,
              int box_rows, int pw) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)rs * 2, (cuuint64_t)hs * 2,
                                 (cuuint64_t)bs * 2};
  const cuuint32_t box[4] = {(cuuint32_t)pw, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      pw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : (pw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace bf16

int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int H, int K, int Sq, int Skv, int hd,
               const Strides& st, int causal, int window, int q_off,
               int kv_len, int p_bf16, float scale, float cap,
               cudaStream_t stream) {
  return launch_for_head_dim(hd, [&](auto head_dim) {
    constexpr int HD = decltype(head_dim)::value;
    auto kern = f32::flash_f32_kernel<HD>;
    const size_t bytes = f32::Layout<HD>::bytes;
    if (cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes)) != cudaSuccess)
      return;  // the error stays for cudaGetLastError
    const dim3 grid((Sq + f32::kTileQ - 1) / f32::kTileQ, H, B);
    kern<<<grid, f32::kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), H, K, Sq, Skv, st, causal, window, q_off,
        kv_len, p_bf16, scale, cap);
  });
}

int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int H, int K, int Sq, int Skv, int hd,
                const Strides& st, int causal, int window, int q_off,
                int kv_len, float scale, float cap, cudaStream_t stream) {
  bool mapped = true;
  const int err = launch_for_head_dim(hd, [&](auto head_dim) {
    constexpr int HD = decltype(head_dim)::value;
    using Tl = bf16::Tiles<HD>;
    CUtensorMap qmap, kmap, vmap;
    mapped = bf16::make_map(&qmap, q, HD, Sq, H, B, st.qs, st.qh, st.qb,
                            bf16::kTileQ, Tl::PW) &&
             bf16::make_map(&kmap, k, HD, Skv, K, B, st.ks, st.kh, st.kb,
                            Tl::TK, Tl::PW) &&
             bf16::make_map(&vmap, v, HD, Skv, K, B, st.vs, st.vh, st.vb,
                            Tl::TK, Tl::PW);
    if (!mapped) return;
    auto kern = bf16::flash_bf16_kernel<HD>;
    if (cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Tl::kSmem)) != cudaSuccess)
      return;  // the error stays for cudaGetLastError
    const dim3 grid(H, B, (Sq + bf16::kTileQ - 1) / bf16::kTileQ);
    kern<<<grid, bf16::kThreads, Tl::kSmem, stream>>>(
        qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o),
        static_cast<float*>(lse), H, K, Sq, Skv, st.ob, st.oh, st.os, causal,
        window, q_off, kv_len, scale, cap);
  });
  return mapped ? err : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {16, 32, 64, 96, 128, 256}.
// q (B,H,Sq,hd), k/v (B,K,Skv,hd) and o (B,H,Sq,hd) are addressed through
// their (batch, head, position) strides in elements (multiples of 16 bytes),
// the last dimension contiguous, the starts 16-byte aligned; lse is a
// contiguous (B,H,Sq) f32.  window <= 0 is global; q_offset >= 0 is the
// position of query row 0 and kv_len (1..Skv) the number of live keys;
// p_bf16 rounds the probabilities to bf16 before P.V in the f32 variant
// (the bf16 variant always does).  Every query row must have a live key
// (the wrapper checks).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue if a tensor
// map is refused).
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* o, void* lse, int B,
                               int H, int K, int Sq, int Skv, int hd,
                               long long qb, long long qh, long long qs,
                               long long kb, long long kh, long long ks,
                               long long vb, long long vh, long long vs,
                               long long ob, long long oh, long long os,
                               int causal, int window, int q_offset,
                               int kv_len, int p_bf16, float scale, float cap,
                               void* stream) {
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, k, v, o, lse, B, H, K, Sq, Skv, hd, st, causal,
                      window, q_offset, kv_len, p_bf16, scale, cap, s);
  if (dtype == 1)
    return launch_bf16(q, k, v, o, lse, B, H, K, Sq, Skv, hd, st, causal,
                       window, q_offset, kv_len, scale, cap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
