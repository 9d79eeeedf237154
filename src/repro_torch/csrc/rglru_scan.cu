// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t: one thread per
// (batch, channel) runs the chain through time tiles that cp.async stages
// in shared memory, several tiles ahead.  Two entries share the body: the
// plain one takes a and b; the gated one takes the block's x, r and i and
// forms a and b in the same launch.
//
// Replaces: src/repro/kernels/rglru_scan.py::_rglru_kernel (the Pallas TPU
// kernel behind rglru_scan_kernel), and adds an optional f32 initial state
// h0 and the final state as a second output.  The gated entry computes
// what src/repro/models/rglru.py::rglru_scan computes (gates + recurrence).
//
// What bounds it on an H100: bytes.  The plain entry reads a and b once
// and writes y once, 12 bytes per (batch, step, channel): ~252 MB (~75 us
// at 3.35 TB/s) at recurrentgemma-2b's prefill shape (4, 2048, 2560).  At
// a decode tick (8, 1, 2560) the work is ~0.25 MB: the launch is the cost,
// and the gated entry's gain is the ~16 elementwise launches it replaces.
//
// Design: the TPU kernel carried h per (batch, width tile) in VMEM across a
// sequential grid of time blocks.  Here a block owns `ch` channels of one
// batch row for the whole sequence (ch chosen by the caller so that the
// B * R chains make one even wave over the SMs), so nothing carries
// between blocks.  Its 256 threads keep kStages - 1 tiles of `steps` time
// steps in flight (16-byte cp.async where the rows allow it, 4-byte or
// plain copies where they do not), tens of KB per SM.  For each tile the
// gated entry forms a and b with all 256 threads, then the first ch
// threads each run their channel's chain through the tile.  The update
// is __fmul_rn then __fadd_rn (no fused multiply-add), and the gates are
// formed in the plain version's order with its roundings (no fast math,
// softplus as logaddexp(lam, 0) the way PyTorch's CUDA kernel forms it),
// so both entries can equal their plain versions bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCh = kThreads;      // one chain a thread
constexpr int kStages = 4;            // ring of tiles, kStages - 1 in flight
constexpr int kMaxSteps = 32;         // time steps of a tile
constexpr int kRingBytes = 96 * 1024;

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

template <int kVec>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kVec == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// torch.logaddexp(a, 0) as PyTorch's CUDA kernel forms it
__device__ __forceinline__ float softplus(float a) {
  const float b = 0.f;
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return __fadd_rn(m, log1pf(expf(-fabsf(a - b))));
}

// The plain entry: a and b (f32) go through the ring to the chain.
struct Plain {
  using In = float;
  using Out = float;
  static constexpr int kIn = 2;
  static constexpr bool kGated = false;
};
// The gated entry: x, r and i in T; a and b formed per tile in f32.
template <typename T>
struct Gated {
  using In = T;
  using Out = T;
  static constexpr int kIn = 3;
  static constexpr bool kGated = true;
};

struct Args {
  const void* in[3];    // plain: a, b; gated: x, r, i (B, S, R)
  const void* lam;      // gated: (R,) in the inputs' type
  const float* h0;      // (B, R) or null
  void* y;              // (B, S, R)
  float* h_out;         // (B, R)
  int B, S, R, ch, steps;
};

template <class G>
size_t smem_bytes(int ch, int steps) {
  const size_t tile = static_cast<size_t>(steps) * ch;
  return kStages * G::kIn * tile * sizeof(typename G::In) +
         (G::kGated ? (2 * tile + ch) * sizeof(float) : 0);
}

template <class G, int kVec>
__global__ void __launch_bounds__(kThreads) rglru_kernel(Args p) {
  using In = typename G::In;
  using Out = typename G::Out;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tile = static_cast<size_t>(p.steps) * p.ch;
  In* ring = reinterpret_cast<In*>(smem);   // [kStages][kIn][steps][ch]
  float* ab = reinterpret_cast<float*>(smem + kStages * G::kIn * tile *
                                                  sizeof(In));  // [2][..]
  float* na = ab + 2 * tile;                // [ch] -8 softplus(lam)
  const int tiles_per_row = (p.R + p.ch - 1) / p.ch;
  const int bb = blockIdx.x / tiles_per_row;
  const int c0 = (blockIdx.x - bb * tiles_per_row) * p.ch;
  const int cw = min(p.ch, p.R - c0);
  const int tid = threadIdx.x;
  const int ntile = (p.S + p.steps - 1) / p.steps;

  auto load = [&](int k) {                  // tile k into slot k % kStages
    const int t0 = k * p.steps, rows = min(p.steps, p.S - t0);
    for (int q = 0; q < G::kIn; ++q) {
      const In* src = static_cast<const In*>(p.in[q]) +
                      (static_cast<size_t>(bb) * p.S + t0) * p.R + c0;
      In* dst = ring + (static_cast<size_t>(k % kStages) * G::kIn + q) * tile;
      if constexpr (kVec == 0) {
        for (int e = tid; e < rows * cw; e += kThreads) {
          const int r = e / cw, j = e - r * cw;
          dst[r * p.ch + j] = src[static_cast<size_t>(r) * p.R + j];
        }
      } else {
        constexpr int kPer = kVec / static_cast<int>(sizeof(In));
        const int per_row = cw / kPer;
        for (int e = tid; e < rows * per_row; e += kThreads) {
          const int r = e / per_row, v = e - r * per_row;
          cp_async<kVec>(dst + r * p.ch + v * kPer,
                         src + static_cast<size_t>(r) * p.R + v * kPer);
        }
      }
    }
  };

  if constexpr (G::kGated) {
    const In* lam = static_cast<const In*>(p.lam);
    for (int j = tid; j < cw; j += kThreads)
      na[j] = __fmul_rn(softplus(to_f32(lam[c0 + j])), -8.f);
  }
  float h = 0.f;
  if (tid < cw && p.h0 != nullptr)
    h = p.h0[static_cast<size_t>(bb) * p.R + c0 + tid];

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < ntile) load(k);
    cp_commit();
  }
  for (int k = 0; k < ntile; ++k) {
    cp_wait<kStages - 2>();                 // this thread's copies of tile k
    __syncthreads();                        // everyone's; tile k - 1 consumed
    if (k + kStages - 1 < ntile) load(k + kStages - 1);
    cp_commit();
    const int t0 = k * p.steps, rows = min(p.steps, p.S - t0);
    const In* in = ring + static_cast<size_t>(k % kStages) * G::kIn * tile;
    const float* ta;
    const float* tb;
    if constexpr (G::kGated) {
      // the plain version's order: log_a = (-8 softplus(lam)) r, a =
      // exp(log_a), b = (sqrt(-expm1(2 log_a)) i) x
      for (int e = tid; e < rows * p.ch; e += kThreads) {
        const int j = e % p.ch;
        if (j >= cw) continue;
        const float x = to_f32(in[e]), r = to_f32(in[tile + e]);
        const float i = to_f32(in[2 * tile + e]);
        const float log_a = __fmul_rn(na[j], r);
        ab[e] = expf(log_a);
        const float beta = sqrtf(-expm1f(__fmul_rn(2.f, log_a)));
        ab[tile + e] = __fmul_rn(__fmul_rn(beta, i), x);
      }
      __syncthreads();
      ta = ab;
      tb = ab + tile;
    } else {
      ta = in;
      tb = in + tile;
    }
    if (tid < cw) {
      Out* yp = static_cast<Out*>(p.y) +
                (static_cast<size_t>(bb) * p.S + t0) * p.R + c0 + tid;
      for (int r = 0; r < rows; ++r) {
        h = __fadd_rn(__fmul_rn(ta[r * p.ch + tid], h), tb[r * p.ch + tid]);
        yp[static_cast<size_t>(r) * p.R] = from_f32<Out>(h);
      }
    }
  }
  cp_wait<0>();
  if (tid < cw) p.h_out[static_cast<size_t>(bb) * p.R + c0 + tid] = h;
}

// The widest copy every row of every input allows: 16 or 4 bytes, or 0
// (element by element, synchronous).
template <class G>
int copy_bytes(const Args& a) {
  const size_t row = static_cast<size_t>(a.R) * sizeof(typename G::In);
  for (int v : {16, 4}) {
    bool ok = row % v == 0;
    for (int q = 0; q < G::kIn; ++q)
      ok = ok && reinterpret_cast<uintptr_t>(a.in[q]) % v == 0;
    if (ok) return v;
  }
  return 0;
}

template <class G, int kVec>
int launch_vec(const Args& a, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      rglru_kernel<G, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(a.B) * ((a.R + a.ch - 1) / a.ch);
  rglru_kernel<G, kVec><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

template <class G>
int launch(Args a, cudaStream_t st) {
  if (a.B < 1 || a.S < 1 || a.R < 1 || a.ch < 8 || a.ch > kMaxCh ||
      a.ch % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_step = kStages * G::kIn * a.ch *
                       static_cast<int>(sizeof(typename G::In));
  a.steps = std::min({kMaxSteps, a.S, std::max(1, kRingBytes / per_step)});
  const size_t smem = smem_bytes<G>(a.ch, a.steps);
  switch (copy_bytes<G>(a)) {
    case 16: return launch_vec<G, 16>(a, smem, st);
    case 4: return launch_vec<G, 4>(a, smem, st);
    default: return launch_vec<G, 0>(a, smem, st);
  }
}

}  // namespace

// a, b, y (B, S, R) f32; h0 (B, R) f32 or NULL (zero start); h_out (B, R)
// f32; ch channels a block (a multiple of 8, at most 256).  Returns the
// CUDA error of the launch.
extern "C" int rglru_scan(const void* a, const void* b, const void* h0,
                          void* y, void* h_out, int B, int S, int R, int ch,
                          void* stream) {
  Args p{{a, b, nullptr}, nullptr, static_cast<const float*>(h0), y,
         static_cast<float*>(h_out), B, S, R, ch, 0};
  return launch<Plain>(p, static_cast<cudaStream_t>(stream));
}

// dtype: 0 = float32, 1 = bfloat16 (x, r, i, lam and y share it).  x, r, i,
// y (B, S, R); lam (R,); h0 (B, R) f32 or NULL; h_out (B, R) f32; ch as
// above.  Returns the CUDA error of the launch.
extern "C" int rglru_gated_scan(int dtype, const void* x, const void* r,
                                const void* i, const void* lam,
                                const void* h0, void* y, void* h_out, int B,
                                int S, int R, int ch, void* stream) {
  Args p{{x, r, i}, lam, static_cast<const float*>(h0), y,
         static_cast<float*>(h_out), B, S, R, ch, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<Gated<float>>(p, st);
  if (dtype == 1) return launch<Gated<__nv_bfloat16>>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
