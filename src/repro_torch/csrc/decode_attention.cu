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
// and every other cache row keeps its bits.  The body, attend_keys in
// attention_common.cuh, is shared with paged_attention.cu: only the address
// of a key's row differs.
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
#include "attention_common.cuh"

namespace {

template <typename T, int NPL>
__global__ void decode_attention_kernel(
    const T* __restrict__ q, T* __restrict__ kc, T* __restrict__ vc,
    const T* __restrict__ nk, const T* __restrict__ nv,
    const int* __restrict__ pos, T* __restrict__ out, int H, int K, int L,
    int window, float scale, float cap) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  // The engine passes clip(pos, 0, L-1); clamp again so that no launch can
  // write outside the cache.
  const int p = min(max(pos[b], 0), L - 1);
  const int lo = window > 0 ? max(p - window + 1, 0) : 0;
  const size_t stride = (size_t)K * 32 * NPL;  // elements between positions
  const size_t base = (size_t)b * L * stride + (size_t)kh * 32 * NPL;
  attend_keys<T, NPL>(
      q, kc, vc, nk, nv, out, b, kh, H, K, nk != nullptr, p, lo, p,
      [=](int t) { return base + (size_t)t * stride; }, scale, cap);
}

template <typename T>
int launch(const void* q, void* k, void* v, const void* nk, const void* nv,
           const void* pos, void* out, int B, int H, int K, int L, int hd,
           int window, float scale, float cap, cudaStream_t stream) {
  return launch_for_head_dim(hd, [&](auto npl) {
    decode_attention_kernel<T, decltype(npl)::value>
        <<<dim3(K, B), dim3(32 * (H / K)), 0, stream>>>(
            static_cast<const T*>(q), static_cast<T*>(k),
            static_cast<T*>(v), static_cast<const T*>(nk),
            static_cast<const T*>(nv), static_cast<const int*>(pos),
            static_cast<T*>(out), H, K, L, window, scale, cap);
  });
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
