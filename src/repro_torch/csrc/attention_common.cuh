// Helpers shared by the attention kernels (decode_attention.cu,
// paged_attention.cu, flash_attention.cu): f32/bf16 conversion, warp
// reductions and the head_dim dispatch of the launchers.  The two decode
// kernels' common body is split_decode.cuh.
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
