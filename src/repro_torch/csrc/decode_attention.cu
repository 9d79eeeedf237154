// Decode attention for the serve tick, with the new token's K/V row written
// into the cache in the same launch.
//
// Replaces: src/repro/kernels/decode_attention.py::_decode_kernel (the Pallas
// TPU kernel behind decode_attention / decode_attention_fused).
//
// What bounds it on an H100: bytes.  Each slot reads its live cache prefix
// once (keys lo_b..pos[b] of K and V) and does 4*hd flops per key and q
// head, far below the card's ~20 flops per byte at f32 (295 at bf16), so
// the floor is live KV bytes / 3.35 TB/s: 3.6 us at 8 slots of llama3-8b
// with 2875 live keys.  At that size the latency of the loads and of the
// launch, not the bytes, sets the time.
//
// Design: the TPU kernel ran an ordered grid over KV blocks and carried the
// online-softmax state (m, l, acc) in VMEM scratch.  Hopper has no ordered
// grid, and one block per (slot, kv head) is only 64 blocks on 132 SMs, each
// walking its keys one dependent round trip after another.  So the keys of
// a row are split: a thread block cluster of S <= 8 blocks owns one (slot b,
// kv head kh), and block r of the cluster takes chunks clo+r, clo+r+S, ...
// of CHUNK keys of that row's live range [lo_b, pos[b]] (clo = lo_b /
// CHUNK; chunks past pos[b] are not visited, so short rows leave blocks
// idle and a sliding window skips whole chunks).  A block stages its
// chunk's live K and V rows in shared memory once, all with 16-byte
// cp.async copies in flight together, so the G = H/K q heads of the group
// read each K/V byte from device memory once.  Then each thread scores one
// key against all G heads (q, pre-scaled, in shared memory), each warp runs
// the softmax of some heads over the chunk, and the threads accumulate
// P.V over (head, column pair) items, carrying (m, l, acc) across the
// block's chunks in shared memory.  The blocks of a cluster then combine
// their partials in the same launch through distributed shared memory:
// after a cluster barrier each block reads every block's (m, l), weighs
// them by exp(m_r - max m), and sums its share of the (head, column) items
// of acc over the blocks; a second barrier keeps every block's shared
// memory alive until all have read it.  A block without a live chunk
// offers the empty partial (m = -inf, l = 0), which weighs 0 and is never
// read.  A row whose live keys lie in one chunk (or a launch with S = 1) is
// finished by block 0 alone, with no barrier: the choice depends only on
// pos[b] and the window, so every block of the cluster takes it alike.
//
// The fused write: the new K/V row is stored at pos[b] exactly once, by the
// block whose chunk holds pos[b]; that block stages the row from new_k /
// new_v (the same bits), so no block depends on the write's visibility.
// Every other cache row keeps its bits.
//
// Arithmetic follows the JAX package: q is scaled by hd^-0.5 before the dot,
// the softcap cap*tanh(s/cap) comes before masking, only live keys enter the
// softmax, the final division clamps l at 1e-37, the output is cast to q's
// dtype.  Loads are f32 or bf16 (template), accumulation is f32.  head_dim
// is 16, 32, 64, 96, 128 or 256.
#include <cooperative_groups.h>

#include "attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kHeadTile = 8;    // q heads scored per pass over a K row

constexpr int clamp_chunk(int x) { return x < 32 ? 32 : (x > 256 ? 256 : x); }

// CHUNK keys of K and V take about 64 KB of shared memory: 128 keys at
// bf16/hd 128, 64 at f32/hd 128.  Rows carry 16 bytes of padding, so that
// the 16-byte reads of 8 threads on 8 neighbouring rows hit distinct banks.
template <typename T, int HD>
struct Cfg {
  static constexpr int ROW = HD * int(sizeof(T));  // bytes of one K/V row
  static constexpr int PITCH = ROW + 16;            // its pitch in smem
  static constexpr int PIECES = ROW / 16;           // 16-byte pieces a row
  static constexpr int VE = 16 / int(sizeof(T));    // elements a piece
  static constexpr int CHUNK = clamp_chunk(pow2_floor(32768 / ROW));
};

// Shared-memory layout for G q heads, in bytes: K and V rows, q (f32,
// scaled), scores then probabilities, the accumulator, the running m, l and
// correction of each head, and the cluster combine's (m, l) table, weights
// and totals.
template <typename T, int HD>
struct Smem {
  using C = Cfg<T, HD>;
  size_t ks, vs, qs, ps, acc, m, l, corr, cm, cl, tot, bytes;
  __host__ __device__ explicit Smem(int G) {
    ks = 0;
    vs = ks + (size_t)C::CHUNK * C::PITCH;
    qs = vs + (size_t)C::CHUNK * C::PITCH;
    ps = qs + sizeof(float) * G * HD;
    acc = ps + sizeof(float) * G * C::CHUNK;
    m = acc + sizeof(float) * G * HD;
    l = m + sizeof(float) * G;
    corr = l + sizeof(float) * G;
    cm = corr + sizeof(float) * G;
    cl = cm + sizeof(float) * kMaxCluster * G;
    tot = cl + sizeof(float) * kMaxCluster * G;
    bytes = tot + sizeof(float) * G;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x, hidden from the optimizer.  Without it NVVM rewrites a chunk's row
// count n = min(c*CHUNK + CHUNK - 1, p) - t0 + 1 (p = min(max(pos, 0),
// L - 1)) as ~max(-(c*CHUNK + CHUNK), -L, ~max(pos, 0)) - t0, and ptxas of
// CUDA 12.9 fuses the two max.s32 into one VIMNMX3 whose operand L, read
// from the parameter bank, loses its negation: n came out as ~L - t0 + 1
// (-64 at L = 64) and every output was NaN.  The PTX is right; the SASS is
// not.  Through this the expression stays as written.
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ void load_piece(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x, f[1] = x.y, f[2] = x.z, f[3] = x.w;
}

__device__ __forceinline__ void load_piece(const __nv_bfloat16* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 y = __bfloat1622float2(h[i]);
    f[2 * i] = y.x, f[2 * i + 1] = y.y;
  }
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, T* __restrict__ kc, T* __restrict__ vc,
    const T* __restrict__ nk, const T* __restrict__ nv,
    const int* __restrict__ pos, T* __restrict__ out, int H, int K, int L,
    int window, float scale, float cap) {
  using C = Cfg<T, HD>;
  constexpr int CHUNK = C::CHUNK;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = gridDim.x;  // blocks of the cluster, one cluster per (b, kh)
  const int r = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // The engine passes clip(pos, 0, L-1); clamp again so that no launch can
  // write outside the cache.
  const int p = min(max(pos[b], 0), L - 1);
  const int lo = window > 0 ? max(p - window + 1, 0) : 0;
  const int clo = lo / CHUNK;
  const int nchunks = p / CHUNK - clo + 1;
  const bool alone = S == 1 || nchunks == 1;  // the same in every block
  if (alone && r != 0) return;

  const Smem<T, HD> lay(G);
  unsigned char* Ks = smem + lay.ks;
  unsigned char* Vs = smem + lay.vs;
  float* qs = reinterpret_cast<float*>(smem + lay.qs);
  float* ps = reinterpret_cast<float*>(smem + lay.ps);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  float* m_run = reinterpret_cast<float*>(smem + lay.m);
  float* l_run = reinterpret_cast<float*>(smem + lay.l);
  float* corr = reinterpret_cast<float*>(smem + lay.corr);

  const size_t stride = (size_t)K * HD;  // elements between positions
  const size_t base = (size_t)b * L * stride + (size_t)kh * HD;
  const size_t nrow = ((size_t)b * K + kh) * HD;
  const bool fused = nk != nullptr;
  if (fused && (nchunks - 1) % S == r) {  // this block's chunks hold p
    for (int i = tid; i < C::PIECES; i += kThreads) {
      const size_t off = i * C::VE;
      *reinterpret_cast<uint4*>(kc + base + p * stride + off) =
          *reinterpret_cast<const uint4*>(nk + nrow + off);
      *reinterpret_cast<uint4*>(vc + base + p * stride + off) =
          *reinterpret_cast<const uint4*>(nv + nrow + off);
    }
  }
  const T* qg = q + ((size_t)b * H + (size_t)kh * G) * HD;
  for (int i = tid; i < G * HD; i += kThreads) {
    qs[i] = to_f32(qg[i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
  }
  __syncthreads();

  for (int c = clo + r; c < clo + nchunks; c += S) {
    const int t0 = max(c * CHUNK, lo);
    const int n = opaque(min(c * CHUNK + CHUNK - 1, p) - t0 + 1);
    for (int i = tid; i < n * C::PIECES; i += kThreads) {
      const int rr = i / C::PIECES;
      const int t = t0 + rr;
      const size_t off = (size_t)(i % C::PIECES) * C::VE;
      const bool self = fused && t == p;
      const T* ksrc = self ? nk + nrow + off : kc + base + t * stride + off;
      const T* vsrc = self ? nv + nrow + off : vc + base + t * stride + off;
      const size_t dst = (size_t)rr * C::PITCH + (i % C::PIECES) * 16;
      cp_async16(Ks + dst, ksrc);
      cp_async16(Vs + dst, vsrc);
    }
    cp_async_wait_all();
    __syncthreads();

    // scores: one key a thread, all G heads, kHeadTile heads a pass
    for (int rr = tid; rr < n; rr += kThreads) {
      const T* krow = reinterpret_cast<const T*>(Ks + (size_t)rr * C::PITCH);
      for (int g0 = 0; g0 < G; g0 += kHeadTile) {
        float a[kHeadTile];
#pragma unroll
        for (int j = 0; j < kHeadTile; ++j) a[j] = 0.f;
#pragma unroll 4
        for (int pc = 0; pc < C::PIECES; ++pc) {
          float kf[C::VE];
          load_piece(krow + pc * C::VE, kf);
#pragma unroll
          for (int j = 0; j < kHeadTile; ++j) {
            if (g0 + j < G) {
              const float* qrow = qs + (g0 + j) * HD + pc * C::VE;
#pragma unroll
              for (int e = 0; e < C::VE; ++e) a[j] = fmaf(qrow[e], kf[e], a[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kHeadTile; ++j) {
          if (g0 + j < G) {
            float x = a[j];
            if (cap != 0.f) x = cap * tanhf(x / cap);
            ps[(g0 + j) * CHUNK + rr] = x;
          }
        }
      }
    }
    __syncthreads();

    // online softmax over the chunk: a warp per head
    for (int g = warp; g < G; g += kWarps) {
      float* srow = ps + g * CHUNK;
      float mx = -INFINITY;
      for (int rr = lane; rr < n; rr += 32) mx = fmaxf(mx, srow[rr]);
      const float m_new = fmaxf(m_run[g], warp_max(mx));
      float sum = 0.f;
      for (int rr = lane; rr < n; rr += 32) {
        const float e = expf(srow[rr] - m_new);
        srow[rr] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float cr = expf(m_run[g] - m_new);  // 0 on the first chunk
        corr[g] = cr;
        l_run[g] = l_run[g] * cr + sum;
        m_run[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P.V over (head, column pair) items
    for (int i = tid; i < G * HD / 2; i += kThreads) {
      const int g = i / (HD / 2);
      const int d = 2 * (i % (HD / 2));
      const float* prow = ps + g * CHUNK;
      const float cr = corr[g];
      float a0 = acc[g * HD + d] * cr, a1 = acc[g * HD + d + 1] * cr;
      const T* vcol = reinterpret_cast<const T*>(Vs) + d;
#pragma unroll 4
      for (int rr = 0; rr < n; ++rr) {
        const float pr = prow[rr];
        const float2 vv = load_pair(vcol + (size_t)rr * (C::PITCH / sizeof(T)));
        a0 = fmaf(pr, vv.x, a0);
        a1 = fmaf(pr, vv.y, a1);
      }
      acc[g * HD + d] = a0;
      acc[g * HD + d + 1] = a1;
    }
    __syncthreads();  // the next chunk overwrites Ks, Vs and ps
  }

  T* og = out + ((size_t)b * H + (size_t)kh * G) * HD;
  if (alone) {
    for (int i = tid; i < G * HD; i += kThreads)
      og[i] = from_f32<T>(acc[i] / fmaxf(l_run[i / HD], 1e-37f));
    return;
  }

  // combine the S partials of the cluster through distributed shared memory
  cg::cluster_group cluster = cg::this_cluster();
  float* cm = reinterpret_cast<float*>(smem + lay.cm);
  float* cl = reinterpret_cast<float*>(smem + lay.cl);
  float* tot = reinterpret_cast<float*>(smem + lay.tot);
  cluster.sync();
  for (int i = tid; i < S * G; i += kThreads) {
    const int rank = i / G, g = i % G;
    cm[i] = cluster.map_shared_rank(m_run, rank)[g];
    cl[i] = cluster.map_shared_rank(l_run, rank)[g];
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float mx = -INFINITY;
    for (int rank = 0; rank < S; ++rank)
      if (cl[rank * G + g] > 0.f) mx = fmaxf(mx, cm[rank * G + g]);
    float total = 0.f;
    for (int rank = 0; rank < S; ++rank) {
      const int j = rank * G + g;
      const float w = cl[j] > 0.f ? expf(cm[j] - mx) : 0.f;  // empty: 0
      cm[j] = w;
      total += w * cl[j];
    }
    tot[g] = fmaxf(total, 1e-37f);
  }
  __syncthreads();
  const int per = (G * HD + S - 1) / S;
  const int i_end = min((r + 1) * per, G * HD);
  for (int i = r * per + tid; i < i_end; i += kThreads) {
    const int g = i / HD;
    float a = 0.f;
    for (int rank = 0; rank < S; ++rank) {
      const float w = cm[rank * G + g];
      if (w > 0.f) a = fmaf(w, cluster.map_shared_rank(acc, rank)[i], a);
    }
    og[i] = from_f32<T>(a / tot[g]);
  }
  cluster.sync();  // no block leaves while another may read its partial
}

template <typename T>
int launch(const void* q, void* k, void* v, const void* nk, const void* nv,
           const void* pos, void* out, int B, int H, int K, int L, int hd,
           int window, float scale, float cap, cudaStream_t stream) {
  if (B == 0) return 0;
  cudaError_t err = cudaSuccess;
  const int launched = launch_for_head_dim(hd, [&](auto head_dim) {
    constexpr int HD = decltype(head_dim)::value;
    auto kern = decode_attention_kernel<T, HD>;
    const size_t bytes = Smem<T, HD>(H / K).bytes;
    if (cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes)) != cudaSuccess)
      return;  // the error stays for cudaGetLastError
    const int chunks = (L + Cfg<T, HD>::CHUNK - 1) / Cfg<T, HD>::CHUNK;
    const int S = chunks < kMaxCluster ? chunks : kMaxCluster;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(S, K, B);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q),
                             static_cast<T*>(k), static_cast<T*>(v),
                             static_cast<const T*>(nk),
                             static_cast<const T*>(nv),
                             static_cast<const int*>(pos),
                             static_cast<T*>(out), H, K, L, window, scale,
                             cap);
  });
  return err != cudaSuccess ? static_cast<int>(err) : launched;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {16, 32, 64, 96, 128, 256}.
// q (B,H,hd); k/v caches (B,L,K,hd); nk/nv (B,K,hd); pos (B,) int32; all
// contiguous and 16-byte aligned.  nk == nv == NULL attends a cache that
// already holds the new row.  One launch: a cluster of min(8, ceil(L /
// CHUNK)) blocks per (slot, kv head).  Returns cudaGetLastError() after the
// launch.
extern "C" int decode_attention(int dtype, const void* q, void* k, void* v,
                                const void* nk, const void* nv,
                                const void* pos, void* out, int B, int H,
                                int K, int L, int hd, int window, float scale,
                                float cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, nk, nv, pos, out, B, H, K, L, hd, window,
                         scale, cap, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, nk, nv, pos, out, B, H, K, L, hd,
                                 window, scale, cap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
