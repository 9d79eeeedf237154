// Fused next-token sampling: greedy argmax or Gumbel-max at a temperature,
// one launch for all rows.
//
// Replaces: src/repro/kernels/sampling.py::_sample_kernel (the Pallas TPU
// kernel behind fused_sample).
//
// What bounds it on an H100: bytes.  Every logit is read once (B*V*4 bytes)
// and the hash and two logs per temperature-row element are cheap next to
// that; the floor is B*V*4 / 3.35 TB/s.
//
// Design: the TPU kernel walked the vocab in blocks in grid order and carried
// a running (max, first index) in scratch.  Here one block owns one row:
// threads stride the vocab (so each thread sees its indices in ascending
// order and keeps its first maximum), then a warp-shuffle and shared-memory
// reduction picks the larger value and breaks ties toward the smaller index.
// NaN counts as larger than any number and the first NaN wins, which is
// torch.argmax's and jnp.argmax's rule; greedy rows are therefore bitwise
// the first-occurrence argmax.  Temperature rows add Gumbel noise from a
// murmur3-finalizer hash of (key words, flat index b*V + v) in wrapping
// uint32, u = (bits >> 9) * 2^-23 + 2^-24, g = -log(-log(u)), with IEEE
// division and logf (not __logf) so that the plain version gives the same
// tokens.  Known limit: only B blocks run (8 at 8 slots), so a handful of
// SMs stream the logits; splitting a row over blocks is later work.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

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

__global__ void fused_sample_kernel(const float* __restrict__ logits,
                                    const float* __restrict__ temps,
                                    const long long* __restrict__ key,
                                    int* __restrict__ out, int V) {
  const int b = blockIdx.x;
  const float t = temps[b];
  const bool hot = t > 0.f;
  const float tt = fmaxf(t, 1e-6f);
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  const uint32_t base = static_cast<uint32_t>(b) * static_cast<uint32_t>(V);
  const float* row = logits + static_cast<size_t>(b) * V;

  float best = -INFINITY;
  int bi = INT_MAX;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    float x = row[v];
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
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(ob, oi, best, bi)) {
      best = ob;
      bi = oi;
    }
  }
  __shared__ float sbest[32];
  __shared__ int sidx[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sbest[warp] = best;
    sidx[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    best = lane < nw ? sbest[lane] : -INFINITY;
    bi = lane < nw ? sidx[lane] : INT_MAX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ob, oi, best, bi)) {
        best = ob;
        bi = oi;
      }
    }
    if (lane == 0) out[b] = bi;
  }
}

}  // namespace

// logits (B, V) f32, temps (B,) f32, key (2,) int64 holding uint32 words,
// out (B,) int32.  Returns cudaGetLastError() after the launch.
extern "C" int fused_sample(const void* logits, const void* temps,
                            const void* key, void* out, int B, int V,
                            int threads, void* stream) {
  fused_sample_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(temps),
      static_cast<const long long*>(key), static_cast<int*>(out), V);
  return static_cast<int>(cudaGetLastError());
}
