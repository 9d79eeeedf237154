// Decode attention for the serve tick, with the new token's K/V row written
// into the cache in the same launch.
//
// Replaces: src/repro/kernels/decode_attention.py::_decode_kernel (the Pallas
// TPU kernel behind decode_attention / decode_attention_fused).
//
// What bounds it on an H100: bytes.  Each slot reads its live cache prefix
// once (keys lo_b..pos[b] of K and V) and does 4*hd flops per key and q
// head, far below the card's ~20 flops per byte at f32 (295 at bf16), so
// the floor is live KV bytes / 3.35 TB/s: 3.6 us at 8 slots of llama3-8b
// with 2875 live keys.  At that size the latency of the loads and of the
// launch, not the bytes, sets the time.
//
// Design: the body is split_decode.cuh's, the split-K cluster body that
// the paged kernel shares, here with the dense key policy (DenseKeys: key
// t of slot b is row (b, t) of the cache, pos clamped into [0, L-1]).  The
// TPU kernel ran an ordered grid over KV blocks and carried the
// online-softmax state in VMEM scratch; here a cluster of S <= 8 blocks
// owns one (slot, kv head), each block stages its chunks' live K and V rows
// in shared memory by cp.async once for the G q heads of the group, and the
// partial softmax states combine through distributed shared memory in the
// same launch (the header's note says how, and what still limits it).
//
// The fused write: the new K/V row is stored at pos[b] exactly once, by the
// block whose chunk holds pos[b]; that block stages the row from new_k /
// new_v (the same bits), so no block depends on the write's visibility.
// Every other cache row keeps its bits.
//
// Arithmetic follows the JAX package (the header's note); loads are f32 or
// bf16, accumulation is f32, head_dim is 16, 32, 64, 96, 128 or 256.
#include "split_decode.cuh"

namespace {

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, T* __restrict__ kc, T* __restrict__ vc,
    const T* __restrict__ nk, const T* __restrict__ nv,
    const int* __restrict__ pos, T* __restrict__ out, int H, int K,
    int window, float scale, float cap, DenseKeys keys) {
  split_decode<T, HD>(q, kc, vc, nk, nv, pos, out, H, K, window, scale, cap,
                      keys);
}

template <typename T>
int launch(const void* q, void* k, void* v, const void* nk, const void* nv,
           const void* pos, void* out, int B, int H, int K, int L, int hd,
           int window, float scale, float cap, cudaStream_t stream) {
  if (B == 0) return 0;
  cudaError_t err = cudaSuccess;
  const int launched = launch_for_head_dim(hd, [&](auto head_dim) {
    constexpr int HD = decltype(head_dim)::value;
    err = launch_split<T, HD>(decode_attention_kernel<T, HD>, q, k, v, nk, nv,
                              pos, out, B, H, K, window, scale, cap,
                              DenseKeys{L}, stream);
  });
  return err != cudaSuccess ? static_cast<int>(err) : launched;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {16, 32, 64, 96, 128, 256}.
// q (B,H,hd); k/v caches (B,L,K,hd); nk/nv (B,K,hd); pos (B,) int32; all
// contiguous and 16-byte aligned.  nk == nv == NULL attends a cache that
// already holds the new row.  One launch: a cluster of min(8, ceil(L /
// CHUNK)) blocks per (slot, kv head).  Returns cudaGetLastError() after the
// launch.
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
