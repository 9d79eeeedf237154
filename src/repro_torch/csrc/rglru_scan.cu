// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t: one thread per
// (batch, channel) walks time with h in a register.
//
// Replaces: src/repro/kernels/rglru_scan.py::_rglru_kernel (the Pallas TPU
// kernel behind rglru_scan_kernel), and adds an optional f32 initial state
// h0 and the final state as a second output.
//
// What bounds it on an H100: bytes.  a and b are read once and y written
// once, 12 bytes per (batch, step, channel): ~210 MB (~63 us at 3.35 TB/s)
// at recurrentgemma-2b's prefill shape (4, 2048, 2560).  At a decode tick
// (8, 1, 2560) the work is ~0.25 MB: the launch is the cost.
//
// Design: the TPU kernel carried h per (batch, width tile) in VMEM across a
// sequential grid of time blocks and stepped the rows of each tile.  Here
// each thread owns one channel of one batch row for the whole sequence, so
// nothing carries between blocks; neighbouring threads own neighbouring
// channels, so each time step's loads and stores are coalesced.  Loads are
// issued kUnroll steps ahead of the dependent chain.  The update is
// __fmul_rn then __fadd_rn (no fused multiply-add), the two roundings of
// the plain PyTorch version, so the kernel equals it bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 8;

__global__ void rglru_scan_kernel(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  const float* __restrict__ h0,
                                  float* __restrict__ y,
                                  float* __restrict__ h_out, int B, int S,
                                  int R) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(B) * R) return;
  const int bb = static_cast<int>(idx / R), r = static_cast<int>(idx % R);
  const size_t base = static_cast<size_t>(bb) * S * R + r;
  float h = h0 != nullptr ? h0[idx] : 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t o = base + static_cast<size_t>(t + u) * R;
      av[u] = a[o];
      bv[u] = b[o];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      y[base + static_cast<size_t>(t + u) * R] = h;
    }
  }
  for (; t < S; ++t) {
    const size_t o = base + static_cast<size_t>(t) * R;
    h = __fadd_rn(__fmul_rn(a[o], h), b[o]);
    y[o] = h;
  }
  h_out[idx] = h;
}

}  // namespace

// a, b, y (B, S, R) f32; h0 (B, R) f32 or NULL (zero start); h_out (B, R)
// f32.  Returns the CUDA error of the launch.
extern "C" int rglru_scan(const void* a, const void* b, const void* h0,
                          void* y, void* h_out, int B, int S, int R,
                          int threads, void* stream) {
  const long long n = static_cast<long long>(B) * R;
  const int blocks = static_cast<int>((n + threads - 1) / threads);
  rglru_scan_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_out), B, S, R);
  return static_cast<int>(cudaGetLastError());
}
