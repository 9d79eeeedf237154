// Set-associative LRU cache simulation of line traces: [hits, misses] per
// problem, where a problem is one trace against one cache (one set count).
//
// Replaces: src/repro/kernels/cache_sim.py::_ladder_kernel (the Pallas TPU
// kernel behind cache_sim_ladder: every (trace x capacity rung) pair in one
// call, set and tag derived from raw line ids) and ::_cachesim_kernel (the
// one behind cache_sim: one cache over precomputed set ids and tags).
//
// LRU semantics (bit-exact with the TPU kernels): tags start at -1 (empty)
// and ages at 0; a hit is the lowest way whose tag matches; on a miss the
// victim is the first way of maximum age, so empty ways fill in order; the
// touched way's age becomes 0 and every other way of the row ages by one.
//
// Design: bucket -> collapse -> walk, each problem on its own, all problems
// of a call (or of a group of them, below) in every launch.
//
//  1. Bucket.  LSD radix passes of 8 bits over the set id make each set's
//     accesses contiguous, in trace order: ceil(bits(ns - 1) / 8) passes (0
//     for one set, 1 up to 256 sets, 2 up to 65,536, 3 beyond).  A pass is
//     three kernels over chunks of 32 KB of accesses: digit_histogram counts
//     each chunk's 256 digits (a warp's lanes of one digit found by one
//     ballot a digit bit in pass 0, by __match_any_sync after it; one
//     shared atomic a group); exclusive_scan turns
//     the (problem, digit, chunk) counts, digit-major, into each (digit,
//     chunk)'s first slot; digit_scatter places the chunk in digit order in
//     shared memory (warps own contiguous eighths and go in order, lanes
//     rank among equal digits by __popc of the lower lanes) and writes each
//     digit's run to its slot, neighbouring threads to neighbouring
//     addresses.  Every step keeps trace order among equal digits, so the
//     scatter is stable and the LSD passes sort.  The ladder carries line
//     ids (4 bytes) and derives set = line % ns and tag = line / ns where it
//     needs them; the per-point call carries (set, tag) pairs (8 bytes).
//  2. Collapse.  An access whose predecessor in its set's bucket has the
//     same tag is a hit and is dropped (collapse_count counts them and the
//     kept accesses and buckets of each chunk, exclusive_scan places the
//     chunks, collapse_write writes the kept tags and each bucket's first
//     kept slot).  Exact for every ways >= 1: the predecessor left that tag
//     in the set's most recently used way (age 0, every other way older),
//     so the repeat hits that way; it sets its age to 0 again and ages
//     every other way by one.  That keeps the order of the ways' ages, and
//     the empty ways (age = the set's access count) stay tied among
//     themselves and older than every filled way, so every later hit and
//     victim is the one it would have been.
//  3. Walk.  One thread per bucket holds its set's ways in registers, in
//     order of age (lru_access says why that is the same cache; compiled
//     for each way count 1..16), and applies the kept accesses in order,
//     the next eight tags in flight; counts reduce per problem by a warp
//     sum and one atomic a warp.  The launcher's `tile` is the walk's block
//     size.
//
// What bounds it on an H100.  (a) The bucketing passes' bytes: per access
// and pass a histogram read, a scatter read and a write, then a collapse
// read (twice, the second from L1) and a write of the kept tags; ~8.5 GB
// for slice C's 2^28 line accesses, ~3 ms at 3.35 TB/s.  The staged
// scatter writes whole runs instead of one sector a lane.  (b) The longest
// collapsed bucket times one dependent update: a set's accesses stay
// serial.  The collapse shortens slice C's longest chain from 709,576
// accesses (the hottest zipf line) to 11,755; an update is one compare and
// one select a way, with no search for the oldest way (it is the last in
// age order) and no ages to add to.  The work is O(problems x T), not
// O(blocks x T) as when every block walked the whole trace.
//
// Scratch: the caller allocates scratch_bytes() for its group of problems
// and passes it in; nothing here allocates.  Indices over problems x T are
// 64-bit; within a problem they are int (T <= 2^31 - 4097).
#include <cuda_runtime.h>

#include <utility>

namespace {

constexpr int kMaxWays = 16;
constexpr int kMaxTile = 1024;          // walk threads per block
constexpr int kRadixBits = 8;
constexpr int kDigits = 1 << kRadixBits;
constexpr int kThreads = kDigits;       // bucket and collapse blocks
constexpr int kWarps = kThreads / 32;
constexpr int kChunkBytes = 32768;      // a bucket/collapse block's chunk
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;           // consecutive values per scan thread
constexpr int kAhead = 8;               // tags a walk thread loads at once
constexpr int kMaxPasses = 4;           // set ids < 2^31
constexpr int kMaxStages = 3 * kMaxPasses + 4;
constexpr int kMaxProblems = 65535;     // grid.y
constexpr int kEmpty = -1;
constexpr unsigned kFull = 0xffffffffu;

// Division of a line id in [0, 2^31) by a set count ns >= 1 without a
// divide: q = n * m >> k with k = 31 + ceil(log2 ns), m = ceil(2^k / ns) <
// 2^32.  Exact: with e = m * ns - 2^k < ns <= 2^(k - 31), n * m / 2^k
// exceeds n / ns by n * e / (ns * 2^k) < 1 / ns for n < 2^31, too little
// to reach the next integer.
struct Divider {
  int ns, k;
  unsigned m;
  __device__ explicit Divider(int d) : ns(d) {
    k = 31 + (d > 1 ? 32 - __clz(d - 1) : 0);
    m = static_cast<unsigned>(((1ULL << k) + d - 1) / d);
  }
  __device__ int quot(int n) const {
    return static_cast<int>(
        (static_cast<unsigned long long>(static_cast<unsigned>(n)) * m) >> k);
  }
};

// An access of the ladder: a line id >= 0 (set = line % ns, tag = line / ns).
struct Lines {
  using Elem = int;
  using Key = Divider;
  static constexpr int kChunk = kChunkBytes / sizeof(Elem);
  static __device__ int set(Elem e, const Key& key) {
    return e - key.quot(e) * key.ns;
  }
  static __device__ int tag(Elem e, const Key& key) { return key.quot(e); }
  // one ns per problem, so the same line is the same set and tag
  static __device__ bool same(Elem a, Elem b) { return a == b; }
};

// An access of the per-point call: its set id and tag.
struct Pairs {
  using Elem = int2;
  struct Key {
    __device__ explicit Key(int) {}
  };
  static constexpr int kChunk = kChunkBytes / sizeof(Elem);
  static __device__ int set(Elem e, const Key&) { return e.x; }
  static __device__ int tag(Elem e, const Key&) { return e.y; }
  static __device__ bool same(Elem a, Elem b) {
    return a.x == b.x && a.y == b.y;
  }
};

__host__ __device__ inline int radix_passes(int ns) {
  int bits = 0;
  for (unsigned v = ns > 1 ? static_cast<unsigned>(ns - 1) : 0u; v; v >>= 1)
    ++bits;
  return (bits + kRadixBits - 1) / kRadixBits;
}

// One group of problems and its scratch; passed by value to every kernel.
// Problem q of a ladder group is rung (q0 + q) / W of trace (q0 + q) % W.
struct Job {
  const int* lines;     // ladder: (W, T) line ids
  const int* ns_of;     // ladder: (L,) set count of each rung
  const int* set_ids;   // per point: (T,) set ids in [0, num_sets)
  const int* tags;      // per point: (T,) tags
  int num_sets;         // per point
  int W, q0, T, nblk;   // nblk chunks of A::kChunk accesses per problem
  int bs;               // bucket slots per problem: min(T, largest ns)
  void* buf[2];         // (P, T) accesses each: the radix ping-pong
  int* hist;            // (P, kDigits, nblk) digit counts, then first slots
  long long* packed;    // (P, nblk) buckets << 32 | kept, then their scan
  long long* totals;    // (P,) buckets << 32 | kept of the whole problem
  int* bstart;          // (P, bs) first kept slot of each bucket
  int* out;             // (P, 2) [hits, misses]

  __device__ int ns(int q) const {
    return lines ? ns_of[(q0 + q) / W] : num_sets;
  }
};

// The buffer a problem's accesses are read from by radix pass `pass` (-1:
// the input); pass p writes buf[p & 1].
__device__ __forceinline__ int source_of(int pass) {
  return pass == 0 ? -1 : (pass - 1) & 1;
}

template <class A> struct Reader;

template <> struct Reader<Lines> {
  const int* p;
  __device__ Reader(const Job& j, int q, int src)
      : p(src < 0 ? j.lines + static_cast<long long>((j.q0 + q) % j.W) * j.T
                  : static_cast<const int*>(j.buf[src]) +
                        static_cast<long long>(q) * j.T) {}
  __device__ int operator[](int i) const { return p[i]; }
};

template <> struct Reader<Pairs> {
  const int2* p;
  const int* sid;
  const int* tag;
  __device__ Reader(const Job& j, int q, int src)
      : p(src < 0 ? nullptr
                  : static_cast<const int2*>(j.buf[src]) +
                        static_cast<long long>(q) * j.T),
        sid(j.set_ids), tag(j.tags) {}
  __device__ int2 operator[](int i) const {
    return p ? p[i] : make_int2(sid[i], tag[i]);
  }
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << lane_id()) - 1u;
}

// This block's chunk [lo, hi) of its problem.
template <class A>
__device__ __forceinline__ void chunk_of(const Job& j, int& lo, int& hi) {
  const long long l = static_cast<long long>(blockIdx.x) * A::kChunk;
  lo = static_cast<int>(l);
  hi = static_cast<int>(min(static_cast<long long>(j.T), l + A::kChunk));
}

// The lanes whose digit equals this lane's, among those with `valid`.  Pass
// 0 reads trace order, where a warp's digits are mostly distinct and
// __match_any_sync is slow, so it takes one ballot a digit bit; the later
// passes read accesses grouped by their lower digits, where few distinct
// digits make __match_any_sync the cheaper.
__device__ __forceinline__ unsigned digit_peers(int d, bool valid, int pass) {
  if (pass > 0) return __match_any_sync(kFull, valid ? d : -1);
  unsigned peers = __ballot_sync(kFull, valid);
#pragma unroll
  for (int b = 0; b < kRadixBits; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned ones = __ballot_sync(kFull, bit);
    peers &= bit ? ones : ~ones;
  }
  return peers;
}

template <class A>
__device__ __forceinline__ int digit_of(typename A::Elem e,
                                        const typename A::Key& key, int pass) {
  return (A::set(e, key) >> (kRadixBits * pass)) & (kDigits - 1);
}

template <class A>
__global__ void __launch_bounds__(kThreads)
    digit_histogram(const __grid_constant__ Job j, int pass) {
  const int q = blockIdx.y;
  if (pass >= radix_passes(j.ns(q))) return;
  const typename A::Key key(j.ns(q));
  __shared__ int s_count[kDigits];
  s_count[threadIdx.x] = 0;
  __syncthreads();
  const Reader<A> src(j, q, source_of(pass));
  int lo, hi;
  chunk_of<A>(j, lo, hi);
  for (int i0 = lo; i0 < hi; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const bool valid = i < hi;
    const int d = valid ? digit_of<A>(src[i], key, pass) : 0;
    const unsigned peers = digit_peers(d, valid, pass);
    if (valid && (peers & lanes_below()) == 0)
      atomicAdd(&s_count[d], __popc(peers));
  }
  __syncthreads();
  j.hist[(static_cast<long long>(q) * kDigits + threadIdx.x) * j.nblk +
         blockIdx.x] = s_count[threadIdx.x];
}

// Exclusive prefix sum over the block of one value a thread.
__device__ __forceinline__ int block_exclusive_sum(int x, int* s_tot) {
  const int lane = lane_id(), warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_tot[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += s_tot[w];
  return before + incl - x;
}

// Exclusive prefix sum of n values per problem (block), in place; the
// problem's total to totals[problem] when totals is not null.
template <typename V>
__global__ void __launch_bounds__(kScanThreads)
    exclusive_scan(V* data, long long n, V* totals) {
  __shared__ V s_warp[kScanThreads / 32];
  V* d = data + static_cast<long long>(blockIdx.x) * n;
  const int lane = lane_id(), warp = threadIdx.x >> 5;
  V carry = 0;
  for (long long base = 0; base < n;
       base += static_cast<long long>(kScanItems) * kScanThreads) {
    const long long i0 = base + static_cast<long long>(kScanItems) *
                                    threadIdx.x;
    V x[kScanItems], sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      x[k] = i0 + k < n ? d[i0 + k] : V(0);
      sum += x[k];
    }
    V incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const V y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      V w = s_warp[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const V y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    V run = carry + (warp ? s_warp[warp - 1] : V(0)) + incl - sum;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      if (i0 + k < n) d[i0 + k] = run;
      run += x[k];
    }
    carry += s_warp[kScanThreads / 32 - 1];
    __syncthreads();                   // s_warp is rewritten next round
  }
  if (totals != nullptr && threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Each warp owns a contiguous eighth of the block's chunk.  It counts its
// accesses of each digit, the block turns the counts into each (digit,
// warp)'s first slot of a shared-memory copy of the chunk in digit order
// (digits in order, warps in order), the warp places its accesses there in
// order (rank among equal digits: __popc of the lower lanes), and the block
// writes the copy out, each digit's run to its slot in the destination,
// neighbouring threads to neighbouring addresses.
template <class A>
__global__ void __launch_bounds__(kThreads)
    digit_scatter(const __grid_constant__ Job j, int pass) {
  using Elem = typename A::Elem;
  constexpr int kPerWarp = A::kChunk / kWarps;
  const int q = blockIdx.y;
  if (pass >= radix_passes(j.ns(q))) return;
  const typename A::Key key(j.ns(q));
  __shared__ Elem s_elem[A::kChunk];        // the chunk in digit order
  __shared__ int s_warp[kWarps][kDigits];   // counts, then next slots
  __shared__ int s_shift[kDigits];          // destination - copy slot
  __shared__ int s_tot[kWarps];
  const int t = threadIdx.x, warp = t >> 5;
  const unsigned below = lanes_below();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_warp[w][t] = 0;
  __syncthreads();
  const Reader<A> src(j, q, source_of(pass));
  int lo, hi;
  chunk_of<A>(j, lo, hi);
  // lo is a multiple of kChunk below T <= 2^31 - 4097: no index overflows
  const int wlo = min(hi, lo + warp * kPerWarp);
  const int whi = min(hi, wlo + kPerWarp);
  for (int i0 = wlo; i0 < whi; i0 += 32) {
    const int i = i0 + lane_id();
    const bool valid = i < whi;
    const int d = valid ? digit_of<A>(src[i], key, pass) : 0;
    const unsigned peers = digit_peers(d, valid, pass);
    if (valid && (peers & below) == 0) s_warp[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  int count = 0;                            // thread t owns digit t
#pragma unroll
  for (int w = 0; w < kWarps; ++w) count += s_warp[w][t];
  int slot = block_exclusive_sum(count, s_tot);
  s_shift[t] = j.hist[(static_cast<long long>(q) * kDigits + t) * j.nblk +
                      blockIdx.x] - slot;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp[w][t];
    s_warp[w][t] = slot;
    slot += c;
  }
  __syncthreads();
  for (int i0 = wlo; i0 < whi; i0 += 32) {
    const int i = i0 + lane_id();
    const bool valid = i < whi;
    Elem e{};
    int d = 0;
    if (valid) {
      e = src[i];
      d = digit_of<A>(e, key, pass);
    }
    const unsigned peers = digit_peers(d, valid, pass);
    if (valid) s_elem[s_warp[warp][d] + __popc(peers & below)] = e;
    __syncwarp();
    if (valid && (peers & below) == 0) s_warp[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  Elem* dst = static_cast<Elem*>(j.buf[pass & 1]) +
              static_cast<long long>(q) * j.T;
  for (int k = t; k < hi - lo; k += kThreads) {
    const Elem e = s_elem[k];
    dst[s_shift[digit_of<A>(e, key, pass)] + k] = e;
  }
}

// Whether access i of the bucketed problem is kept (not a repeat of its
// predecessor in its set's bucket) and whether it starts a bucket.
template <class A>
__device__ __forceinline__ void classify(const Reader<A>& src, int i,
                                         const typename A::Key& key,
                                         typename A::Elem& e, bool& kept,
                                         bool& first) {
  e = src[i];
  if (i == 0) {
    kept = first = true;
    return;
  }
  const typename A::Elem p = src[i - 1];
  first = A::set(e, key) != A::set(p, key);
  kept = !A::same(e, p);                 // a new set is a different access
}

template <class A>
__global__ void __launch_bounds__(kThreads)
    collapse_count(const __grid_constant__ Job j) {
  const int q = blockIdx.y, passes = radix_passes(j.ns(q));
  const typename A::Key key(j.ns(q));
  const Reader<A> src(j, q, passes == 0 ? -1 : (passes - 1) & 1);
  int lo, hi;
  chunk_of<A>(j, lo, hi);
  int kept = 0, buckets = 0;
  for (int i0 = lo; i0 < hi; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    typename A::Elem e;
    bool k = false, f = false;
    if (i < hi) classify(src, i, key, e, k, f);
    kept += __syncthreads_count(k);
    buckets += __syncthreads_count(f);
  }
  if (threadIdx.x == 0) {
    j.packed[static_cast<long long>(q) * j.nblk + blockIdx.x] =
        static_cast<long long>(buckets) << 32 | kept;
    if (hi - lo > kept) atomicAdd(&j.out[2 * q], hi - lo - kept);
  }
}

template <class A>
__global__ void __launch_bounds__(kThreads)
    collapse_write(const __grid_constant__ Job j) {
  __shared__ int s_kept[kWarps], s_first[kWarps];
  const int q = blockIdx.y, passes = radix_passes(j.ns(q));
  const typename A::Key key(j.ns(q));
  const int t = threadIdx.x, warp = t >> 5;
  const Reader<A> src(j, q, passes == 0 ? -1 : (passes - 1) & 1);
  int* kept_tags = static_cast<int*>(j.buf[passes & 1]) +
                   static_cast<long long>(q) * j.T;
  int* bstart = j.bstart + static_cast<long long>(q) * j.bs;
  const long long at = j.packed[static_cast<long long>(q) * j.nblk +
                                blockIdx.x];
  int kbase = static_cast<int>(at & 0xffffffffLL);
  int bbase = static_cast<int>(at >> 32);
  int lo, hi;
  chunk_of<A>(j, lo, hi);
  for (int i0 = lo; i0 < hi; i0 += kThreads) {
    const int i = i0 + t;
    typename A::Elem e{};
    bool k = false, f = false;
    if (i < hi) classify(src, i, key, e, k, f);
    const unsigned km = __ballot_sync(kFull, k), fm = __ballot_sync(kFull, f);
    if (lane_id() == 0) {
      s_kept[warp] = __popc(km);
      s_first[warp] = __popc(fm);
    }
    __syncthreads();
    int kat = kbase, bat = bbase;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {        // warps before mine, in order
      if (w == warp) {
        kat = kbase;
        bat = bbase;
      }
      kbase += s_kept[w];
      bbase += s_first[w];
    }
    __syncthreads();                          // s_* are rewritten next round
    if (k) {
      const int slot = kat + __popc(km & lanes_below());
      kept_tags[slot] = A::tag(e, key);
      const int b = bat + __popc(fm & lanes_below());
      if (f && b < j.bs) bstart[b] = slot;    // b < bs unless ids are bad
    }
  }
}

// One access with tag `t` to a set of kWays ways; true on a hit.  The set
// is held as its ways in order of age, youngest first: by_age[r] is the tag
// of the way with the r-th smallest age, -1 for an empty way (the empty
// ways, all of age = the set's access count, are the oldest and fill in way
// order).  That is the TPU kernels' state with the ways renumbered by age,
// and the renumbering shows in no count: a hit is any way holding t (the
// lowest way holding a tag of -1 is also its youngest), and the victim of a
// miss, the first way of maximum age, is an empty way while one is left
// and the oldest way after that, the last entry either way.  The touched
// way becomes the youngest and every way younger than it ages by one place.
template <int kWays>
__device__ __forceinline__ bool lru_access(int (&by_age)[kWays], int t) {
  unsigned match = 0;
#pragma unroll
  for (int r = 0; r < kWays; ++r) match |= by_age[r] == t ? 1u << r : 0u;
  const unsigned first = match & (0u - match);
  const unsigned moves = match ? (first << 1) - 1 : ~0u;   // ranks that age
#pragma unroll
  for (int r = kWays - 1; r > 0; --r)
    by_age[r] = (moves >> r) & 1 ? by_age[r - 1] : by_age[r];
  by_age[0] = t;
  return match != 0;
}

template <int kWays>
__global__ void __launch_bounds__(kMaxTile)
    walk(const __grid_constant__ Job j) {
  const int q = blockIdx.y, passes = radix_passes(j.ns(q));
  const long long total = j.totals[q];
  const long long n_buckets = min(total >> 32, static_cast<long long>(j.bs));
  const int n_kept = static_cast<int>(total & 0xffffffffLL);
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  int hits = 0, misses = 0;
  if (b < n_buckets) {
    const int* bstart = j.bstart + static_cast<long long>(q) * j.bs;
    const int* tags = static_cast<const int*>(j.buf[passes & 1]) +
                      static_cast<long long>(q) * j.T;
    const int beg = bstart[b];
    const int end = b + 1 < n_buckets ? bstart[b + 1] : n_kept;
    int by_age[kWays];
#pragma unroll
    for (int r = 0; r < kWays; ++r) by_age[r] = kEmpty;
    // the next kAhead tags load while the current ones are applied
    int cur[kAhead], next[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      cur[k] = beg + k < end ? tags[beg + k] : 0;
    for (int i = beg; i < end; i += kAhead) {
#pragma unroll
      for (int k = 0; k < kAhead; ++k)
        next[k] = i + kAhead + k < end ? tags[i + kAhead + k] : 0;
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        if (i + k < end) {
          if (lru_access<kWays>(by_age, cur[k]))
            ++hits;
          else
            ++misses;
        }
        cur[k] = next[k];
      }
    }
  }
  // the lanes of this warp that exist (a block need not be whole warps)
  const int first_lane = threadIdx.x & ~31;
  const int n_lanes = min(32, static_cast<int>(blockDim.x) - first_lane);
  const unsigned lanes = n_lanes == 32 ? kFull : (1u << n_lanes) - 1u;
  hits = __reduce_add_sync(lanes, hits);
  misses = __reduce_add_sync(lanes, misses);
  if (lane_id() == 0 && (hits | misses)) {
    atomicAdd(&j.out[2 * q], hits);
    atomicAdd(&j.out[2 * q + 1], misses);
  }
}

// The walk for `ways` (1..kMaxWays), each compiled for its way count.
template <int kWays>
void launch_walk(const Job& j, dim3 grid, int tile, cudaStream_t st) {
  walk<kWays><<<grid, tile, 0, st>>>(j);
}

using WalkLauncher = void (*)(const Job&, dim3, int, cudaStream_t);

template <int... kWays>
WalkLauncher walk_launcher(int ways, std::integer_sequence<int, kWays...>) {
  static constexpr WalkLauncher table[] = {launch_walk<kWays + 1>...};
  return table[ways - 1];
}

// ------------------------------------------------------------------ host

struct Layout {
  long long buf, hist, packed, totals, bstart, bytes;
};

long long align_up(long long x) { return (x + 255) / 256 * 256; }

int chunks(int T, int elem_bytes) {
  const int chunk = kChunkBytes / elem_bytes;
  return static_cast<int>((static_cast<long long>(T) + chunk - 1) / chunk);
}

Layout layout(int P, int T, int max_ns, int elem_bytes) {
  const long long nblk = chunks(T, elem_bytes);
  const long long bs = T < max_ns ? T : max_ns;
  Layout l;
  l.buf = align_up(static_cast<long long>(P) * T * elem_bytes);
  l.hist = align_up(P * kDigits * nblk * 4);
  l.packed = align_up(P * nblk * 8);
  l.totals = align_up(P * 8LL);
  l.bstart = align_up(P * bs * 4);
  l.bytes = 2 * l.buf + l.hist + l.packed + l.totals + l.bstart;
  return l;
}

void carve(Job& j, void* scratch, const Layout& l) {
  char* p = static_cast<char*>(scratch);
  j.buf[0] = p;
  j.buf[1] = p += l.buf;
  j.hist = reinterpret_cast<int*>(p += l.buf);
  j.packed = reinterpret_cast<long long*>(p += l.hist);
  j.totals = reinterpret_cast<long long*>(p += l.packed);
  j.bstart = reinterpret_cast<int*>(p += l.totals);
}

// Every kernel of one group in order; with stage_ms (host floats, up to
// kMaxStages) also each kernel's time between CUDA events, after a
// synchronisation of the stream.
template <class A>
int run(Job j, int P, int max_ns, int tile, int ways, cudaStream_t st,
        float* stage_ms) {
  cudaMemsetAsync(j.out, 0, sizeof(int) * 2 * P, st);
  if (j.T == 0) return static_cast<int>(cudaGetLastError());
  cudaEvent_t ev[kMaxStages + 1];
  int n_ev = 0;
  auto mark = [&]() {
    if (stage_ms == nullptr) return;
    cudaEventCreate(&ev[n_ev]);
    cudaEventRecord(ev[n_ev++], st);
  };
  const dim3 grid(j.nblk, P);
  cudaError_t err = cudaSuccess;
  for (int pass = 0; pass < radix_passes(max_ns) && !err; ++pass) {
    mark();
    digit_histogram<A><<<grid, kThreads, 0, st>>>(j, pass);
    mark();
    exclusive_scan<int><<<P, kScanThreads, 0, st>>>(
        j.hist, static_cast<long long>(kDigits) * j.nblk, nullptr);
    mark();
    digit_scatter<A><<<grid, kThreads, 0, st>>>(j, pass);
    err = cudaGetLastError();
  }
  if (!err) {
    mark();
    collapse_count<A><<<grid, kThreads, 0, st>>>(j);
    mark();
    exclusive_scan<long long><<<P, kScanThreads, 0, st>>>(j.packed, j.nblk,
                                                          j.totals);
    mark();
    collapse_write<A><<<grid, kThreads, 0, st>>>(j);
    mark();
    walk_launcher(ways, std::make_integer_sequence<int, kMaxWays>())(
        j, dim3((j.bs + tile - 1) / tile, P), tile, st);
    mark();
    err = cudaGetLastError();
  }
  if (stage_ms != nullptr) {
    cudaEventSynchronize(ev[n_ev - 1]);
    for (int k = 0; k + 1 < n_ev; ++k)
      cudaEventElapsedTime(&stage_ms[k], ev[k], ev[k + 1]);
    for (int k = 0; k < n_ev; ++k) cudaEventDestroy(ev[k]);
    if (!err) err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

bool bad_common(int T, int tile, int ways) {
  return ways < 1 || ways > kMaxWays || tile < 1 || tile > kMaxTile ||
         T < 0 || T > 2147483647 - 4096;
}

}  // namespace

// Bytes of scratch a group of `problems` problems of T accesses needs, the
// largest of them with max_ns sets: ladder != 0 for line ids (the ladder),
// 0 for (set, tag) pairs (the per-point call).
extern "C" long long cache_sim_scratch_bytes(int problems, int T, int max_ns,
                                             int ladder) {
  if (problems < 1 || T < 0 || max_ns < 1) return -1;
  return layout(problems, T, max_ns,
                ladder ? sizeof(Lines::Elem) : sizeof(Pairs::Elem)).bytes;
}

// set_ids, tags (T,) int32; out (2,) int32 [hits, misses]; scratch of
// scratch_bytes >= cache_sim_scratch_bytes(1, T, num_sets, 0); `tile`
// threads per walk block.  Returns the first CUDA error of the launches.
extern "C" int cache_sim(const void* set_ids, const void* tags, void* out,
                         void* scratch, long long scratch_bytes, int T,
                         int num_sets, int tile, int ways, void* stream) {
  if (bad_common(T, tile, ways) || num_sets < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(1, T, num_sets, sizeof(Pairs::Elem));
  if (scratch_bytes < l.bytes || (scratch == nullptr && l.bytes > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Job j{};
  j.set_ids = static_cast<const int*>(set_ids);
  j.tags = static_cast<const int*>(tags);
  j.num_sets = num_sets;
  j.W = 1;
  j.T = T;
  j.nblk = chunks(T, sizeof(Pairs::Elem));
  j.bs = T < num_sets ? T : num_sets;
  j.out = static_cast<int*>(out);
  carve(j, scratch, l);
  return run<Pairs>(j, 1, num_sets, tile, ways,
                    static_cast<cudaStream_t>(stream), nullptr);
}

// traces (W, T) int32 line ids >= 0; ns (L,) int32 set counts on the card;
// problems q0 .. q0 + P - 1 of the W * L (problem q: rung q / W, trace
// q % W), the largest ns of the ladder max_ns; out (P, 2) int32 [hits,
// misses] of those problems; scratch of scratch_bytes >=
// cache_sim_scratch_bytes(P, T, max_ns, 1); stage_ms null or host floats
// for each kernel's time.  Returns the first CUDA error of the launches.
extern "C" int cache_sim_ladder(const void* traces, const void* ns,
                                void* out, void* scratch,
                                long long scratch_bytes, int W, int T,
                                int q0, int P, int max_ns, int tile,
                                int ways, void* stage_ms, void* stream) {
  if (bad_common(T, tile, ways) || W < 1 || q0 < 0 || P < 1 ||
      P > kMaxProblems || max_ns < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(P, T, max_ns, sizeof(Lines::Elem));
  if (scratch_bytes < l.bytes || (scratch == nullptr && l.bytes > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Job j{};
  j.lines = static_cast<const int*>(traces);
  j.ns_of = static_cast<const int*>(ns);
  j.W = W;
  j.q0 = q0;
  j.T = T;
  j.nblk = chunks(T, sizeof(Lines::Elem));
  j.bs = T < max_ns ? T : max_ns;
  j.out = static_cast<int*>(out);
  carve(j, scratch, l);
  return run<Lines>(j, P, max_ns, tile, ways,
                    static_cast<cudaStream_t>(stream),
                    static_cast<float*>(stage_ms));
}
