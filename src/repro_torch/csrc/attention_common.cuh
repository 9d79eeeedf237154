// The body shared by the decode attention kernels (decode_attention.cu,
// paged_attention.cu), templated on how a key's row is addressed, and its
// helpers: f32/bf16 conversion, a lane's vector of head_dim/32 elements,
// the warp sum and the head_dim dispatch of the launchers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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

// One block's work for one (slot b, kv head kh) pair, blockDim = 32 * H/K.
// With ``write``, all threads first store new_k/new_v (B, K, hd) at key p,
// then __syncthreads, which makes the block's global writes visible to its
// own reads, so the self term reads the new row.  Then warp g attends q head
// kh*G + g over keys [lo, last]: lanes split head_dim (NPL = head_dim / 32
// elements each), dot products reduce with warp shuffles, and the online
// softmax runs in f32.  ``row(t)`` is the element offset of key t's row for
// head kh in kc/vc (the address policy: dense, or through a page table).
// Each step scores CHUNK keys whose K and V rows are all loaded before any
// is used, so that a step costs one memory round trip and not one per key;
// keys past ``last`` in the last chunk load the row of ``last`` (always
// mapped) and are masked to -inf.
template <typename T, int NPL, typename Row>
__device__ __forceinline__ void attend_keys(
    const T* __restrict__ q, T* __restrict__ kc, T* __restrict__ vc,
    const T* __restrict__ nk, const T* __restrict__ nv, T* __restrict__ out,
    int b, int kh, int H, int K, bool write, int p, int lo, int last,
    Row row, float scale, float cap) {
  constexpr int hd = 32 * NPL;
  constexpr int CHUNK = 64 / NPL;
  using V = Vec<T, NPL>;
  const int G = H / K;
  const int g = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (write) {
    const size_t dst = row(p);
    const size_t src = ((size_t)b * K + kh) * hd;
    for (int d = threadIdx.x; d < hd; d += blockDim.x) {
      kc[dst + d] = nk[src + d];
      vc[dst + d] = nv[src + d];
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
  for (int t0 = lo; t0 <= last; t0 += CHUNK) {
    V kr[CHUNK], vr[CHUNK];
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      const size_t off = row(min(t0 + c, last)) + lane * NPL;
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
      s[c] = t0 + c <= last ? s[c] : -INFINITY;
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

// Calls launch(std::integral_constant<int, NPL>) for head_dim = 32 * NPL in
// {32, 64, 128, 256}.  Returns cudaErrorInvalidValue for any other head_dim,
// else cudaGetLastError() after the launch.
template <typename F>
int launch_for_head_dim(int hd, F&& launch) {
  switch (hd) {
    case 32:
      launch(std::integral_constant<int, 1>{});
      break;
    case 64:
      launch(std::integral_constant<int, 2>{});
      break;
    case 128:
      launch(std::integral_constant<int, 4>{});
      break;
    case 256:
      launch(std::integral_constant<int, 8>{});
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
