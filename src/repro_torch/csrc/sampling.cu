// Fused next-token sampling: greedy argmax or Gumbel-max at a temperature,
// one launch for all rows.
//
// Replaces: src/repro/kernels/sampling.py::_sample_kernel (the Pallas TPU
// kernel behind fused_sample).
//
// What bounds it on an H100: bytes.  Every logit is read once (B*V*4 bytes)
// and the hash, division and two logs per temperature-row element are
// cheap next to that on the whole card; the floor is B*V*4 / 3.35 TB/s (1.2
// us at 8 rows of a 128256-token vocab).  Streaming at that rate takes
// loads in flight on most of the 132 SMs, and a serve tick has 8 rows or
// fewer, so each row is split over blocks.
//
// Design: the TPU kernel walked the vocab in blocks in grid order and carried
// a running (max, first index) in scratch.  Here a thread block cluster of S
// blocks owns one row (grid (S, B); the caller picks S so that B*S covers
// the SMs, at most 16, and at most one block per THREADS 16-byte pieces of
// the row).  Block r reduces one contiguous slice of the row's 16-byte
// pieces, several float4 loads in flight per thread; the scalars before the
// row's first 16-byte boundary (a row starts there only when V % 4 == 0) go
// to block 0 and those after its last to block S-1.  A warp-shuffle and
// shared-memory reduction gives each block its (best, index); block 0 then
// reads the other blocks' through distributed shared memory after a cluster
// barrier and writes out[b], and a second barrier keeps every block's
// partial alive until it has.  So it stays one launch, with no scratch
// buffer, no atomics and no memset.  The order of the comparisons does not
// matter: better() is a total order on (value, index) (the larger value
// wins, ties go to the smaller index, NaN beats any number and the first NaN
// wins, which is torch.argmax's and jnp.argmax's rule), so greedy rows are
// bitwise the first-occurrence argmax and the result is deterministic.
// Temperature rows add Gumbel noise from a murmur3-finalizer hash of (key
// words, flat index b*V + v) in wrapping uint32, u = (bits >> 9) * 2^-23 +
// 2^-24, g = -log(-log(u)), with IEEE division and logf (not __logf), so
// that the plain version gives the same tokens.
//
// Still limited by the launch and the two cluster barriers, and by the
// cluster's size: a row reaches at most 16 SMs, so a temperature row's
// hash, IEEE division and two IEEE logs per element run on 16 SMs while
// the greedy rows' blocks are done.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 4;  // float4 loads in flight per thread

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Is (a, ia) the better argmax candidate than (b, ib)?
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

// The running (best, index) of one thread over the elements it is given.
struct Best {
  float best = -INFINITY;
  int bi = INT_MAX;
  bool hot;
  float tt;
  uint32_t k0, k1, base;

  __device__ __forceinline__ void take(float x, int v) {
    if (hot) {
      const uint32_t ctr = base + static_cast<uint32_t>(v);
      const uint32_t bits = fmix(fmix(ctr ^ k0) ^ k1);
      const float u = static_cast<float>(bits >> 9) * 1.1920928955078125e-07f +
                      5.9604644775390625e-08f;
      const float g = -logf(-logf(u));
      x = x / tt + g;
    }
    if (better(x, v, best, bi)) {
      best = x;
      bi = v;
    }
  }
  __device__ __forceinline__ void take4(float4 x, int v) {
    take(x.x, v);
    take(x.y, v + 1);
    take(x.z, v + 2);
    take(x.w, v + 3);
  }
  __device__ __forceinline__ void warp_reduce() {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ob, oi, best, bi)) {
        best = ob;
        bi = oi;
      }
    }
  }
};

__global__ void __launch_bounds__(kMaxThreads) fused_sample_kernel(
    const float* __restrict__ logits, const float* __restrict__ temps,
    const long long* __restrict__ key, int* __restrict__ out, int V) {
  const int S = gridDim.x;  // blocks of the cluster, one cluster per row
  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const float t = temps[b];
  Best acc;
  acc.hot = t > 0.f;
  acc.tt = fmaxf(t, 1e-6f);
  acc.k0 = static_cast<uint32_t>(key[0]);
  acc.k1 = static_cast<uint32_t>(key[1]);
  acc.base = static_cast<uint32_t>(b) * static_cast<uint32_t>(V);
  const float* row = logits + static_cast<size_t>(b) * V;

  // scalars up to the first 16-byte boundary, whole float4 pieces, scalars
  // after the last boundary
  const int head = min(
      V, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(row) & 15)) &
                          15) / 4);
  const int npieces = (V - head) / 4;
  const int tail = head + 4 * npieces;
  const float4* pieces = reinterpret_cast<const float4*>(row + head);
  const long long np = npieces;  // block r's pieces [p0, p1)
  const int p0 = static_cast<int>(np * r / S);
  const int p1 = static_cast<int>(np * (r + 1) / S);

  if (r == 0)
    for (int v = tid; v < head; v += nt) acc.take(row[v], v);
  int i = p0 + tid;
  for (; i + (kUnroll - 1) * nt < p1; i += kUnroll * nt) {
    float4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = __ldg(pieces + i + u * nt);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc.take4(x[u], head + 4 * (i + u * nt));
  }
  for (; i < p1; i += nt) acc.take4(__ldg(pieces + i), head + 4 * i);
  if (r == S - 1)
    for (int v = tail + tid; v < V; v += nt) acc.take(row[v], v);

  // the block's (best, index)
  acc.warp_reduce();
  __shared__ float sbest[32];
  __shared__ int sidx[32];
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
    sbest[warp] = acc.best;
    sidx[warp] = acc.bi;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = nt >> 5;
    acc.best = lane < nw ? sbest[lane] : -INFINITY;
    acc.bi = lane < nw ? sidx[lane] : INT_MAX;
    acc.warp_reduce();
  }

  // the cluster's: block 0 reads every block's through distributed shared
  // memory (S <= 32, a lane each)
  __shared__ float cbest;
  __shared__ int cidx;
  if (tid == 0) {
    cbest = acc.best;
    cidx = acc.bi;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (r == 0 && warp == 0) {
    acc.best = lane < S ? *cluster.map_shared_rank(&cbest, lane) : -INFINITY;
    acc.bi = lane < S ? *cluster.map_shared_rank(&cidx, lane) : INT_MAX;
    acc.warp_reduce();
    if (lane == 0) out[b] = acc.bi;
  }
  cluster.sync();  // no block leaves while block 0 may read its partial
}

}  // namespace

// logits (B, V) f32, temps (B,) f32, key (2,) int64 holding uint32 words,
// out (B,) int32.  One launch: grid (blocks, B) in clusters of (blocks, 1,
// 1) of ``threads`` threads (a multiple of 32, at most 1024); blocks above 8
// use the H100's non-portable cluster sizes (at most 16).  Returns the
// error of the attribute or cudaGetLastError() after the launch.
extern "C" int fused_sample(const void* logits, const void* temps,
                            const void* key, void* out, int B, int V,
                            int threads, int blocks, void* stream) {
  if (B == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      fused_sample_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, B);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_sample_kernel,
                           static_cast<const float*>(logits),
                           static_cast<const float*>(temps),
                           static_cast<const long long*>(key),
                           static_cast<int*>(out), V);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
