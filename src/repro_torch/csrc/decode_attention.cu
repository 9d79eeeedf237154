// Decode attention for the serve tick, with the new token's K/V row written
// into the cache in the same launch.
//
// Replaces: src/repro/kernels/decode_attention.py::_decode_kernel (the Pallas
// TPU kernel behind decode_attention / decode_attention_fused).
//
// What bounds it on an H100: bytes.  Each slot reads its live cache prefix
// once (keys lo_b..pos[b] of K and V) and does 4*hd flops per key and q
// head, far below the card's ~20 flops per byte at f32 (295 at bf16), so
// the floor is live KV bytes / 3.35 TB/s.
//
// Design: the TPU kernel ran an ordered grid over KV blocks and carried the
// online-softmax state (m, l, acc) in VMEM scratch, clamping its DMAs with
// scalar-prefetch index maps.  Hopper has no ordered grid, so one block owns
// one (slot b, kv head k) pair and loops over that row's live keys
// [lo_b, pos[b]] itself, computing lo_b from pos and the window: no block is
// wasted on dead keys and nothing is carried between blocks.  Each warp owns
// one q head of the group G = H/K, lanes split head_dim, dot products reduce
// with warp shuffles, and the online softmax runs in f32 per warp.  Keys are
// scored a chunk at a time, with all of the chunk's K and V rows loaded (one
// vector per lane and row) before any is used, so that a chunk costs one
// memory round trip.  The fused variant first writes new_k/new_v at pos[b]
// (all threads of the block, then __syncthreads, which makes the global
// writes visible to the block), so the self-attention term reads the new row
// and every other cache row keeps its bits.
//
// Known limit: one block per (b, k) is B*K = 64 blocks at 8 slots of
// llama3-8b, on 132 SMs, each with G = 4 warps: the card is under-filled
// and latency bound.  Splitting the keys of a row over several blocks
// (split-K with a second reduction pass) is later work.
//
// Arithmetic follows the JAX package: q is scaled by hd^-0.5 before the dot,
// the softcap cap*tanh(s/cap) comes before masking, only live keys enter the
// softmax, the final division clamps l at 1e-37, the output is cast to q's
// dtype.  Loads are f32 or bf16 (template), accumulation is f32.  head_dim
// is 32, 64, 128 or 256: one vector of head_dim/32 elements per lane.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -2.0e38f;

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

// NPL contiguous elements of one lane, loaded as one vector.
template <typename T, int NPL>
struct alignas(sizeof(T) * NPL) Vec {
  T v[NPL];
};

// Butterfly sum: every lane ends with the same bits (a+b == b+a).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// NPL = head_dim / 32 elements per lane.  Each warp step scores CHUNK keys
// whose K and V rows are all loaded before any is used, so that a step costs
// one memory round trip and not one per key; keys past pos[b] in the last
// chunk load the row at pos[b] (always in bounds) and are masked to -inf.
template <typename T, int NPL>
__global__ void decode_attention_kernel(
    const T* __restrict__ q, T* __restrict__ kc, T* __restrict__ vc,
    const T* __restrict__ nk, const T* __restrict__ nv,
    const int* __restrict__ pos, T* __restrict__ out, int H, int K, int L,
    int window, float scale, float cap) {
  constexpr int hd = 32 * NPL;
  constexpr int CHUNK = 64 / NPL;
  using V = Vec<T, NPL>;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / K;
  const int g = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // The engine passes clip(pos, 0, L-1); clamp again so that no launch can
  // write outside the cache.
  const int p = min(max(pos[b], 0), L - 1);
  const int lo = window > 0 ? max(p - window + 1, 0) : 0;
  const size_t stride = (size_t)K * hd;  // elements between positions
  const size_t base = (size_t)b * L * stride + (size_t)kh * hd + lane * NPL;

  if (nk != nullptr) {
    const size_t src = ((size_t)b * K + kh) * hd;
    for (int d = threadIdx.x; d < hd; d += blockDim.x) {
      kc[(size_t)b * L * stride + (size_t)p * stride + (size_t)kh * hd + d] =
          nk[src + d];
      vc[(size_t)b * L * stride + (size_t)p * stride + (size_t)kh * hd + d] =
          nv[src + d];
    }
    __syncthreads();
  }

  const int h = kh * G + g;
  const V qraw =
      *reinterpret_cast<const V*>(q + ((size_t)b * H + h) * hd + lane * NPL);
  float qv[NPL], acc[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    qv[i] = to_f32(qraw.v[i]) * scale;
    acc[i] = 0.f;
  }

  float m = kNegInf, l = 0.f;
  for (int t0 = lo; t0 <= p; t0 += CHUNK) {
    V kr[CHUNK], vr[CHUNK];
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      const size_t off = base + (size_t)min(t0 + c, p) * stride;
      kr[c] = *reinterpret_cast<const V*>(kc + off);
      vr[c] = *reinterpret_cast<const V*>(vc + off);
    }
    float s[CHUNK];
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NPL; ++i) part += qv[i] * to_f32(kr[c].v[i]);
      s[c] = part;
    }
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) s[c] = warp_sum(s[c]);
    float mc = m;
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      if (cap != 0.f) s[c] = cap * tanhf(s[c] / cap);
      s[c] = t0 + c <= p ? s[c] : -INFINITY;
      mc = fmaxf(mc, s[c]);
    }
    const float corr = expf(m - mc);
    l *= corr;
#pragma unroll
    for (int i = 0; i < NPL; ++i) acc[i] *= corr;
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      const float pc = expf(s[c] - mc);  // exactly 0 for masked keys
      l += pc;
#pragma unroll
      for (int i = 0; i < NPL; ++i) acc[i] += pc * to_f32(vr[c].v[i]);
    }
    m = mc;
  }

  const float denom = fmaxf(l, 1e-37f);
  V o;
#pragma unroll
  for (int i = 0; i < NPL; ++i) o.v[i] = from_f32<T>(acc[i] / denom);
  *reinterpret_cast<V*>(out + ((size_t)b * H + h) * hd + lane * NPL) = o;
}

template <typename T>
int launch(const void* q, void* k, void* v, const void* nk, const void* nv,
           const void* pos, void* out, int B, int H, int K, int L, int hd,
           int window, float scale, float cap, cudaStream_t stream) {
  const dim3 grid(K, B);
  const dim3 block(32 * (H / K));
  const T* q_ = static_cast<const T*>(q);
  T* k_ = static_cast<T*>(k);
  T* v_ = static_cast<T*>(v);
  const T* nk_ = static_cast<const T*>(nk);
  const T* nv_ = static_cast<const T*>(nv);
  const int* pos_ = static_cast<const int*>(pos);
  T* out_ = static_cast<T*>(out);
  switch (hd) {
    case 32:
      decode_attention_kernel<T, 1><<<grid, block, 0, stream>>>(
          q_, k_, v_, nk_, nv_, pos_, out_, H, K, L, window, scale, cap);
      break;
    case 64:
      decode_attention_kernel<T, 2><<<grid, block, 0, stream>>>(
          q_, k_, v_, nk_, nv_, pos_, out_, H, K, L, window, scale, cap);
      break;
    case 128:
      decode_attention_kernel<T, 4><<<grid, block, 0, stream>>>(
          q_, k_, v_, nk_, nv_, pos_, out_, H, K, L, window, scale, cap);
      break;
    case 256:
      decode_attention_kernel<T, 8><<<grid, block, 0, stream>>>(
          q_, k_, v_, nk_, nv_, pos_, out_, H, K, L, window, scale, cap);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {32, 64, 128, 256}.  nk == nv ==
// NULL attends a cache that already holds the new row.  Returns
// cudaGetLastError() after the launch.
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
