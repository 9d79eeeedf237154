// Helpers shared by the attention kernels (decode_attention.cu,
// paged_attention.cu, flash_attention.cu): f32/bf16 conversion, warp
// reductions, the head_dim dispatch of the launchers, and the paged
// kernel's body (attend_keys), templated on how a key's row is addressed.
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

// NE contiguous elements, loaded as one vector (NE a power of two).
template <typename T, int NE>
struct alignas(sizeof(T) * NE) Vec {
  T v[NE];
};

// Butterfly sum: every lane ends with the same bits (a+b == b+a).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

constexpr int pow2_floor(int x) { return x >= 2 ? 2 * pow2_floor(x / 2) : 1; }

// How the lanes of a warp split one head_dim row in attend_keys: vectors
// of NE elements (at most 16 bytes, a power of two dividing HD), lane i
// holding vectors i, i + 32, ... (NV of them); vectors past HD / NE are
// masked (hd 16 uses 16 lanes, hd 96 half of its second vector); ALL says
// at compile time that none is.  A chunk of CHUNK keys keeps CHUNK * NV *
// NE elements of K and of V per lane in registers, 64 (32 at hd 16 and 32,
// where more spills).
template <typename T, int HD>
struct Lanes {
  static constexpr int NE =
      pow2_floor(HD / 32 > 1 ? HD / 32 : 1) < int(16 / sizeof(T))
          ? pow2_floor(HD / 32 > 1 ? HD / 32 : 1)
          : int(16 / sizeof(T));
  static constexpr int NVEC = HD / NE;
  static constexpr int NV = (NVEC + 31) / 32;
  static constexpr bool ALL = NVEC % 32 == 0;
  static constexpr int CHUNK = 64 / (NE * NV) < 32 ? 64 / (NE * NV) : 32;
  static_assert(HD % NE == 0 && CHUNK >= 1, "head_dim");
};

// One block's work for one (slot b, kv head kh) pair, blockDim = 32 * H/K.
// With ``write``, all threads first store new_k/new_v (B, K, HD) at key p,
// then __syncthreads, which makes the block's global writes visible to its
// own reads, so the self term reads the new row.  Then warp g attends q head
// kh*G + g over keys [lo, last]: lanes split head_dim (Lanes<T, HD>), dot
// products reduce with warp shuffles, and the online softmax runs in f32.
// ``row(t)`` is the element offset of key t's row for head kh in kc/vc (the
// address policy: through a page table).  Each step scores CHUNK keys whose
// K and V rows are all loaded before any is used, so that a step costs one
// memory round trip and not one per key; keys past ``last`` in the last
// chunk load the row of ``last`` (always mapped) and are masked to -inf.
template <typename T, int HD, typename Row>
__device__ __forceinline__ void attend_keys(
    const T* __restrict__ q, T* __restrict__ kc, T* __restrict__ vc,
    const T* __restrict__ nk, const T* __restrict__ nv, T* __restrict__ out,
    int b, int kh, int H, int K, bool write, int p, int lo, int last,
    Row row, float scale, float cap) {
  using Ly = Lanes<T, HD>;
  constexpr int NE = Ly::NE, NV = Ly::NV, CHUNK = Ly::CHUNK;
  using V = Vec<T, NE>;
  const int G = H / K;
  const int g = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (write) {
    const size_t dst = row(p);
    const size_t src = ((size_t)b * K + kh) * HD;
    for (int d = threadIdx.x; d < HD; d += blockDim.x) {
      kc[dst + d] = nk[src + d];
      vc[dst + d] = nv[src + d];
    }
    __syncthreads();
  }

  bool on[NV];
  int col[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    on[i] = Ly::ALL || lane + 32 * i < Ly::NVEC;
    col[i] = (lane + 32 * i) * NE;
  }
  const int h = kh * G + g;
  const T* qrow = q + ((size_t)b * H + h) * HD;
  float qv[NV][NE], acc[NV][NE];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const V qraw = on[i] ? *reinterpret_cast<const V*>(qrow + col[i]) : V{};
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      qv[i][e] = to_f32(qraw.v[e]) * scale;
      acc[i][e] = 0.f;
    }
  }

  float m = kNegInf, l = 0.f;
  for (int t0 = lo; t0 <= last; t0 += CHUNK) {
    V kr[CHUNK][NV], vr[CHUNK][NV];
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      const size_t off = row(min(t0 + c, last));
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        kr[c][i] = on[i] ? *reinterpret_cast<const V*>(kc + off + col[i])
                         : V{};
        vr[c][i] = on[i] ? *reinterpret_cast<const V*>(vc + off + col[i])
                         : V{};
      }
    }
    float s[CHUNK];
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < NE; ++e) part += qv[i][e] * to_f32(kr[c][i].v[e]);
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
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[i][e] *= corr;
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      const float pc = expf(s[c] - mc);  // exactly 0 for masked keys
      l += pc;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[i][e] += pc * to_f32(vr[c][i].v[e]);
    }
    m = mc;
  }

  const float denom = fmaxf(l, 1e-37f);
  T* orow = out + ((size_t)b * H + h) * HD;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (!on[i]) continue;
    V o;
#pragma unroll
    for (int e = 0; e < NE; ++e) o.v[e] = from_f32<T>(acc[i][e] / denom);
    *reinterpret_cast<V*>(orow + col[i]) = o;
  }
}

// Calls launch(std::integral_constant<int, HD>) for every head_dim the
// model configs use (16, 32, 64, 96, 128, 256).  Returns
// cudaErrorInvalidValue for any other head_dim, else cudaGetLastError()
// after the launch.
template <typename F>
int launch_for_head_dim(int hd, F&& launch) {
  switch (hd) {
    case 16:
      launch(std::integral_constant<int, 16>{});
      break;
    case 32:
      launch(std::integral_constant<int, 32>{});
      break;
    case 64:
      launch(std::integral_constant<int, 64>{});
      break;
    case 96:
      launch(std::integral_constant<int, 96>{});
      break;
    case 128:
      launch(std::integral_constant<int, 128>{});
      break;
    case 256:
      launch(std::integral_constant<int, 256>{});
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
