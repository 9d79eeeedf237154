// The split-K decode-attention body shared by decode_attention.cu (a dense
// (B, L, K, hd) cache) and paged_attention.cu (a (P, ps, K, hd) page pool
// read through a page table).  The two compute the same function except for
// the address of a key's row and a few edge rules; a key policy (DenseKeys,
// PagedKeys) carries both, and everything else here is common.
//
// What bounds it on an H100: bytes.  Each slot reads its live keys once (K
// and V rows of keys lo_b..last_b) and does 4*hd flops per key and q head,
// far below the card's ~20 flops per byte at f32 (295 at bf16), so the
// floor is the live KV bytes / 3.35 TB/s, a few microseconds at 8 slots of
// llama3-8b.  At that size the launch, the latency of the first loads and
// the cluster barriers set the time, not the bytes.
//
// Design: the TPU kernels ran an ordered grid over KV blocks (pages) and
// carried the online-softmax state (m, l, acc) in VMEM scratch.  Hopper has
// no ordered grid, and one block per (slot, kv head) is only 64 blocks on
// 132 SMs, each walking its keys one dependent round trip after another.  So
// the keys of a row are split: a thread block cluster of S <= 8 blocks owns
// one (slot b, kv head kh), and block r of the cluster takes chunks clo+r,
// clo+r+S, ... of CHUNK keys of that row's live range [lo_b, last_b] (clo =
// lo_b / CHUNK; chunks past last_b are not visited, so short rows leave
// blocks idle and a sliding window skips whole chunks).  A block first
// stages what addresses its keys (the policy's stage(): nothing for a dense
// cache; the clamped page ids of pages lo_b/ps .. last_b/ps for a paged
// one) in shared memory beside q, so no copy waits on a dependent global
// load.  Then it stages its chunk's live K and V rows in shared memory, all
// with 16-byte cp.async copies in flight together (a chunk may span pages:
// each row's address comes from the policy's row()), so the G = H/K q heads
// of the group read each K/V byte from device memory once.  Each thread
// scores one key against all G heads (q, pre-scaled, in shared memory),
// each warp runs the softmax of some heads over the chunk, and the threads
// accumulate P.V over (head, column pair) items, carrying (m, l, acc)
// across the block's chunks in shared memory.  The blocks of a cluster then
// combine their partials in the same launch through distributed shared
// memory: after a cluster barrier each block reads every block's (m, l),
// weighs them by exp(m_r - max m), and sums its share of the (head, column)
// items of acc over the blocks; a second barrier keeps every block's shared
// memory alive until all have read it.  A block without a live chunk offers
// the empty partial (m = -inf, l = 0), which weighs 0 and is never read.  A
// row whose live keys lie in one chunk (or none, or a launch with S = 1) is
// finished by block 0 alone, with no barrier: the choice depends only on
// pos[b] and the window, so every block of the cluster takes it alike.  A
// row with no live key writes zeros.
//
// The fused write: the new K/V row goes to key last_b exactly once, by the
// block whose chunk holds it, after the block's first barrier (the paged
// policy's page ids are staged by then); for its scores that block stages
// the row from new_k / new_v (the same bits), so no block depends on the
// write's visibility.  Every other cache row keeps its bits.
//
// Still limited by: the launch and one cp.async round per chunk (the
// scores wait for the whole chunk), and two cluster barriers; at the serve
// tick's short rows these, not bytes, are the time.
//
// Arithmetic follows the JAX package: q is scaled by hd^-0.5 before the dot,
// the softcap cap*tanh(s/cap) comes before masking, only live keys enter the
// softmax, the final division clamps l at 1e-37, the output is cast to q's
// dtype.  Loads are f32 or bf16 (template), accumulation is f32.  head_dim
// is 16, 32, 64, 96, 128 or 256.
#pragma once

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

// Shared-memory layout for G q heads and a key policy that stages ``tab``
// ints, in bytes: K and V rows, q (f32, scaled), scores then probabilities,
// the accumulator, the running m, l and correction of each head, the
// cluster combine's (m, l) table, weights and totals, the policy's table.
template <typename T, int HD>
struct Smem {
  using C = Cfg<T, HD>;
  size_t ks, vs, qs, ps, acc, m, l, corr, cm, cl, tot, tab, bytes;
  __host__ __device__ Smem(int G, int tab_ints) {
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
    tab = tot + sizeof(float) * G;
    bytes = tab + sizeof(int) * tab_ints;
  }
};

// A row's live keys [lo, last] (none when last < lo) and whether the new
// row is written, at key last.
struct Span {
  int lo, last;
  bool write;
};

// A dense cache (B, L, K, HD): key t of slot b is position row b*L + t.
// The engine passes clip(pos, 0, L-1); it is clamped again so that no launch
// can write outside the cache.
struct DenseKeys {
  int L;
  __host__ __device__ int span_len() const { return L; }
  __host__ __device__ int table_len() const { return 0; }
  __device__ Span span(int pos, int window, bool fused) const {
    const int p = min(max(pos, 0), L - 1);
    return {window > 0 ? max(p - window + 1, 0) : 0, p, fused && p >= 0};
  }
  __device__ void stage(int, const Span&, int*, int) {}
  __device__ size_t row(int b, int t) const { return (size_t)b * L + t; }
};

// A page pool (P, ps, K, HD) through a page table pt (B, nb): key t of slot
// b is row t % ps of page pt[b, t / ps], that is position row page*ps +
// t % ps.  Keys past the table (pos >= nb*ps) are not there: the row attends
// up to the table's last key and writes nothing, as the Pallas kernel's
// clamped grid.  A page id outside the pool is clamped into [0, P-1], so
// that no launch can read or write outside it; the engine never maps one.
struct PagedKeys {
  const int* pt;
  int P, ps, nb;
  const int* tab;  // staged ids of pages first, first + 1, ...
  int first;
  __host__ __device__ int span_len() const { return nb * ps; }
  __host__ __device__ int table_len() const { return nb; }
  __device__ Span span(int pos, int window, bool fused) const {
    return {window > 0 ? max(pos - window + 1, 0) : 0,
            min(pos, nb * ps - 1), fused && pos >= 0 && pos < nb * ps};
  }
  // the page ids of the row's live range, before the barrier that follows
  __device__ void stage(int b, const Span& sp, int* smem_tab, int tid) {
    first = sp.lo / ps;
    tab = smem_tab;
    if (sp.last < sp.lo) return;
    const int* ptb = pt + (size_t)b * nb;
    for (int i = tid; i <= sp.last / ps - first; i += kThreads)
      smem_tab[i] = min(max(ptb[first + i], 0), P - 1);
  }
  __device__ size_t row(int, int t) const {
    return (size_t)tab[t / ps - first] * ps + t % ps;
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
// count n = min(c*CHUNK + CHUNK - 1, last) - t0 + 1 (dense: last =
// min(max(pos, 0), L - 1)) as ~max(-(c*CHUNK + CHUNK), -L, ~max(pos, 0)) -
// t0, and ptxas of CUDA 12.9 fuses the two max.s32 into one VIMNMX3 whose
// operand L, read from the parameter bank, loses its negation: n came out as
// ~L - t0 + 1 (-64 at L = 64) and every output was NaN.  The PTX is right;
// the SASS is not.  Through this the expression stays as written, for every
// key policy.
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

// The body, for grid (S, K, B) in clusters of (S, 1, 1) and kThreads
// threads: kc/vc hold position rows of K * HD elements (the policy maps a
// key to its row), q and out are (B, H, HD), nk/nv (B, K, HD) or NULL.
template <typename T, int HD, typename Keys>
__device__ __forceinline__ void split_decode(
    const T* __restrict__ q, T* __restrict__ kc, T* __restrict__ vc,
    const T* __restrict__ nk, const T* __restrict__ nv,
    const int* __restrict__ pos, T* __restrict__ out, int H, int K,
    int window, float scale, float cap, Keys keys) {
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

  const bool fused = nk != nullptr;
  const Span sp = keys.span(pos[b], window, fused);
  const int lo = sp.lo, last = sp.last;
  const int clo = lo / CHUNK;
  const int nchunks = last >= lo ? last / CHUNK - clo + 1 : 0;
  const bool alone = S == 1 || nchunks <= 1;  // the same in every block
  if (alone && r != 0) return;

  const Smem<T, HD> lay(G, keys.table_len());
  unsigned char* Ks = smem + lay.ks;
  unsigned char* Vs = smem + lay.vs;
  float* qs = reinterpret_cast<float*>(smem + lay.qs);
  float* ps = reinterpret_cast<float*>(smem + lay.ps);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  float* m_run = reinterpret_cast<float*>(smem + lay.m);
  float* l_run = reinterpret_cast<float*>(smem + lay.l);
  float* corr = reinterpret_cast<float*>(smem + lay.corr);

  keys.stage(b, sp, reinterpret_cast<int*>(smem + lay.tab), tid);
  const size_t stride = (size_t)K * HD;  // elements between position rows
  const size_t head = (size_t)kh * HD;
  const size_t nrow = ((size_t)b * K + kh) * HD;
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

  if (sp.write && (nchunks - 1) % S == r) {  // this block's chunks hold last
    const size_t dst = keys.row(b, last) * stride + head;
    for (int i = tid; i < C::PIECES; i += kThreads) {
      const size_t off = i * C::VE;
      *reinterpret_cast<uint4*>(kc + dst + off) =
          *reinterpret_cast<const uint4*>(nk + nrow + off);
      *reinterpret_cast<uint4*>(vc + dst + off) =
          *reinterpret_cast<const uint4*>(nv + nrow + off);
    }
  }

  for (int c = clo + r; c < clo + nchunks; c += S) {
    const int t0 = max(c * CHUNK, lo);
    const int n = opaque(min(c * CHUNK + CHUNK - 1, last) - t0 + 1);
    for (int i = tid; i < n * C::PIECES; i += kThreads) {
      const int rr = i / C::PIECES;
      const int t = t0 + rr;
      const size_t off = (size_t)(i % C::PIECES) * C::VE;
      const bool self = sp.write && t == last;
      const size_t src = keys.row(b, t) * stride + head + off;
      const T* ksrc = self ? nk + nrow + off : kc + src;
      const T* vsrc = self ? nv + nrow + off : vc + src;
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
  // Only the empty partial (l == 0) is left out.  A NaN key or value makes
  // its chunk's l or acc NaN, and the tests below are written so that the
  // NaN reaches the output, as it does through the plain version: a
  // corrupt cache row must surface as a non-finite output (the serve
  // engines' health check reads it), not vanish from the sum.
  for (int g = tid; g < G; g += kThreads) {
    float mx = -INFINITY;
    for (int rank = 0; rank < S; ++rank)
      if (cl[rank * G + g] != 0.f) mx = fmaxf(mx, cm[rank * G + g]);
    float total = 0.f;
    for (int rank = 0; rank < S; ++rank) {
      const int j = rank * G + g;
      const float w = cl[j] != 0.f ? expf(cm[j] - mx) : 0.f;  // empty: 0
      cm[j] = w;
      total += w * cl[j];
    }
    tot[g] = total != total ? total : fmaxf(total, 1e-37f);
  }
  __syncthreads();
  const int per = (G * HD + S - 1) / S;
  const int i_end = min((r + 1) * per, G * HD);
  for (int i = r * per + tid; i < i_end; i += kThreads) {
    const int g = i / HD;
    float a = 0.f;
    for (int rank = 0; rank < S; ++rank) {
      const float w = cm[rank * G + g];
      if (w != 0.f) a = fmaf(w, cluster.map_shared_rank(acc, rank)[i], a);
    }
    og[i] = from_f32<T>(a / tot[g]);
  }
  cluster.sync();  // no block leaves while another may read its partial
}

// Launches ``kern`` (a __global__ wrapper of split_decode<T, HD, Keys>) as a
// cluster of min(8, ceil(keys.span_len() / CHUNK)) blocks (at least one) per
// (slot, kv head).  Returns the error of the attribute or of the launch.
template <typename T, int HD, typename Keys, typename Kern>
cudaError_t launch_split(Kern kern, const void* q, void* k, void* v,
                         const void* nk, const void* nv, const void* pos,
                         void* out, int B, int H, int K, int window,
                         float scale, float cap, Keys keys,
                         cudaStream_t stream) {
  const size_t bytes = Smem<T, HD>(H / K, keys.table_len()).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int chunks =
      (keys.span_len() + Cfg<T, HD>::CHUNK - 1) / Cfg<T, HD>::CHUNK;
  const int S = chunks < 1 ? 1 : (chunks < kMaxCluster ? chunks : kMaxCluster);
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
  return cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q),
                            static_cast<T*>(k), static_cast<T*>(v),
                            static_cast<const T*>(nk),
                            static_cast<const T*>(nv),
                            static_cast<const int*>(pos),
                            static_cast<T*>(out), H, K, window, scale, cap,
                            keys);
}

}  // namespace
