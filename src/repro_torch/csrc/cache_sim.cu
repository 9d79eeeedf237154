// Set-associative LRU cache simulation: hits and misses of a line trace,
// one count pair per tile of sets.
//
// Replaces: src/repro/kernels/cache_sim.py::_ladder_kernel (the Pallas TPU
// kernel behind cache_sim_ladder: every (trace x capacity rung) pair in one
// launch, set and tag derived from raw line ids) and ::_cachesim_kernel (the
// one behind cache_sim: one cache size over precomputed set ids and tags).
//
// LRU semantics (bit-exact with the TPU kernels): tags start at -1 (empty)
// and ages at 0; a hit is the lowest way whose tag matches; on a miss the
// victim is the first way of maximum age, so empty ways fill in order; the
// touched way's age becomes 0 and every other way of the row ages by one.
//
// What bounds it on an H100: neither bytes nor arithmetic but the order of
// the accesses.  The useful work is W*T*L accesses x (set/tag + `ways`
// compares), microseconds at the int32 rate, and the trace is read from
// device memory once per block (blocks of one trace run together, so it is
// served from the 50 MB L2 after the first).  But one set's accesses must be
// applied in trace order, and the zipf traces put a large share of all
// accesses (the hottest line alone) on one set: that set's thread runs them
// one after another, the floor of any design that keeps one owner per set.
// In this design the walk costs more than that chain at full scale: every
// warp of every block reads every staged access (PERF.md, slice C).
//
// Design: the TPU cell scanned the whole trace in grid order with masked
// vector updates of a (tile, ways) row block.  Hopper blocks run in no
// order, and per-set order is the only order that matters, so one block owns
// one tile of sets (one (trace, rung tile) of the ladder, or one tile of the
// per-point cache) and one thread owns one set, its tags and ages in
// registers (ways <= 16, unrolled).  The block stages the trace through
// shared memory in chunks (the ladder kernel computes line % ns and
// line / ns there, once per element); every thread then walks the chunk in
// order and updates its own set where the row matches.  A block sums its
// threads' counts with shared-memory atomics and writes one int32 pair.
// Known limits, later work: every warp of a block walks every staged access
// (warp-per-set with a ballot over ways, or bucketing the trace by set,
// would cut that), and the hot set's chain stays serial.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWays = 16;
constexpr int kMaxTile = 1024;
constexpr int kChunk = 4096;   // trace elements staged per pass
constexpr int kEmpty = -1;

// One access with tag `t` to the set held in `tag`/`age`; true on a hit.
__device__ __forceinline__ bool lru_access(int (&tag)[kMaxWays],
                                           int (&age)[kMaxWays], int ways,
                                           int t) {
  int hit_way = ways;
#pragma unroll
  for (int w = kMaxWays - 1; w >= 0; --w)
    if (w < ways && tag[w] == t) hit_way = w;          // lowest match
  int victim = 0, oldest = age[0];
#pragma unroll
  for (int w = 1; w < kMaxWays; ++w)
    if (w < ways && age[w] > oldest) {                 // first max age
      oldest = age[w];
      victim = w;
    }
  const bool hit = hit_way < ways;
  const int way = hit ? hit_way : victim;
#pragma unroll
  for (int w = 0; w < kMaxWays; ++w) {
    if (w < ways) {
      const bool touched = w == way;
      tag[w] = touched ? t : tag[w];
      age[w] = touched ? 0 : age[w] + 1;
    }
  }
  return hit;
}

// Walk `n` staged accesses in trace order; those whose row is `me` update
// this thread's set.
__device__ __forceinline__ void walk(const int* srow, const int* stag, int n,
                                     int me, int (&tag)[kMaxWays],
                                     int (&age)[kMaxWays], int ways,
                                     int& hits, int& misses) {
  for (int i = 0; i < n; ++i) {
    if (srow[i] == me) {
      if (lru_access(tag, age, ways, stag[i]))
        ++hits;
      else
        ++misses;
    }
  }
}

__device__ __forceinline__ void init_row(int (&tag)[kMaxWays],
                                         int (&age)[kMaxWays]) {
#pragma unroll
  for (int w = 0; w < kMaxWays; ++w) {
    tag[w] = kEmpty;
    age[w] = 0;
  }
}

// Sum the block's counts into out[0], out[1].
__device__ __forceinline__ void write_counts(int hits, int misses,
                                             int* s_cnt, int* out) {
  atomicAdd(&s_cnt[0], hits);
  atomicAdd(&s_cnt[1], misses);
  __syncthreads();
  if (threadIdx.x == 0) {
    out[0] = s_cnt[0];
    out[1] = s_cnt[1];
  }
}

// Per point: block b owns sets [b * tile, (b + 1) * tile) of one cache.
__global__ void cache_sim_kernel(const int* __restrict__ set_ids,
                                 const int* __restrict__ tags, int T,
                                 int tile, int ways, int* __restrict__ out) {
  __shared__ int srow[kChunk];
  __shared__ int stag[kChunk];
  __shared__ int s_cnt[2];
  if (threadIdx.x == 0) s_cnt[0] = s_cnt[1] = 0;
  const int base = blockIdx.x * tile;
  int tag[kMaxWays], age[kMaxWays];
  init_row(tag, age);
  int hits = 0, misses = 0;
  for (int c0 = 0; c0 < T; c0 += kChunk) {
    const int n = min(kChunk, T - c0);
    __syncthreads();                       // the previous chunk is walked
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      srow[i] = set_ids[c0 + i] - base;
      stag[i] = tags[c0 + i];
    }
    __syncthreads();
    walk(srow, stag, n, threadIdx.x, tag, age, ways, hits, misses);
  }
  __syncthreads();
  write_counts(hits, misses, s_cnt, out + 2 * blockIdx.x);
}

// Ladder: block (g, w) owns sets [base[g], base[g] + tile) of the rung with
// ns[g] sets, for trace w; set = line % ns, tag = line / ns.
__global__ void cache_sim_ladder_kernel(const int* __restrict__ traces,
                                        const int* __restrict__ tile_ns,
                                        const int* __restrict__ tile_base,
                                        int T, int G, int ways,
                                        int* __restrict__ out) {
  __shared__ int srow[kChunk];
  __shared__ int stag[kChunk];
  __shared__ int s_cnt[2];
  if (threadIdx.x == 0) s_cnt[0] = s_cnt[1] = 0;
  const int g = blockIdx.x, w = blockIdx.y;
  const int ns = tile_ns[g], base = tile_base[g];
  const int* trace = traces + static_cast<size_t>(w) * T;
  int tag[kMaxWays], age[kMaxWays];
  init_row(tag, age);
  int hits = 0, misses = 0;
  for (int c0 = 0; c0 < T; c0 += kChunk) {
    const int n = min(kChunk, T - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int line = trace[c0 + i];
      const int q = line / ns;
      srow[i] = line - q * ns - base;
      stag[i] = q;
    }
    __syncthreads();
    walk(srow, stag, n, threadIdx.x, tag, age, ways, hits, misses);
  }
  __syncthreads();
  write_counts(hits, misses, s_cnt,
               out + 2 * (static_cast<size_t>(w) * G + g));
}

}  // namespace

// set_ids, tags (T,) int32; out (n_tiles, 2) int32 [hits, misses] per tile
// of `tile` sets.  Returns cudaGetLastError() after the launch.
extern "C" int cache_sim(const void* set_ids, const void* tags, void* out,
                         int T, int n_tiles, int tile, int ways,
                         void* stream) {
  if (ways < 1 || ways > kMaxWays || tile < 1 || tile > kMaxTile ||
      n_tiles < 1 || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cache_sim_kernel<<<n_tiles, tile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(set_ids), static_cast<const int*>(tags), T,
      tile, ways, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// traces (W, T) int32 line ids >= 0; tile_ns, tile_base (G,) int32; out
// (W, G, 2) int32 [hits, misses] per (trace, tile).  Returns
// cudaGetLastError() after the launch.
extern "C" int cache_sim_ladder(const void* traces, const void* tile_ns,
                                const void* tile_base, void* out, int W,
                                int T, int G, int tile, int ways,
                                void* stream) {
  if (ways < 1 || ways > kMaxWays || tile < 1 || tile > kMaxTile || G < 1 ||
      W < 1 || W > 65535 || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(G, W);
  cache_sim_ladder_kernel<<<grid, tile, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(traces), static_cast<const int*>(tile_ns),
      static_cast<const int*>(tile_base), T, G, ways,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
