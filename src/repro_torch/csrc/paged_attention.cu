// Paged decode attention for the paged serve tick: one query per slot
// attends its keys through a page table over a shared physical KV pool,
// with the new token's K/V row written into the slot's boundary page in the
// same launch.
//
// Replaces: src/repro/kernels/paged_attention.py::_paged_kernel (the Pallas
// TPU kernel behind paged_decode_attention / paged_decode_attention_fused).
//
// What bounds it on an H100: bytes.  Each slot reads its live keys once
// (K and V rows of keys lo_b..pos[b], wherever their pages lie) and does
// 4*hd flops per key and q head, far below the card's ~20 flops per byte at
// f32, so the floor is the live KV bytes / 3.35 TB/s; rows that share
// prefix pages share those bytes, so the floor counts a shared page once.
// At the serve tick's sizes the launch and the latency of the first loads,
// not the bytes, set the time.
//
// Design: the TPU kernel ran an ordered grid (slot b, logical page j) with
// the page table as a scalar-prefetch operand dereferenced by the KV index
// map, and carried the online-softmax state in VMEM scratch.  Here the body
// is the dense decode kernel's (split_decode.cuh), with the paged key
// policy (PagedKeys): a cluster of S = min(8, ceil(nb*ps / CHUNK)) blocks
// owns one (slot b, kv head), block r takes chunks clo + r, clo + r + S,
// ... of CHUNK keys of the row's live range (clo = lo_b / CHUNK; 128 keys
// at bf16/hd 128: 16 pages at ps 8, and with ps 5 a chunk starts and ends
// inside pages), stages their K and V rows in shared memory by 16-byte
// cp.async once for the G = H/K q heads, and the partial softmax states
// combine through distributed shared memory in the same launch.  Only the
// address of a key changes: logical key t is row t % ps of physical page
// pt[b, t / ps].  Key rows of a page are contiguous per kv head, so the
// only new work is the page ids: each block stages the clamped ids of
// pages lo_b/ps .. last_b/ps in shared memory beside q, before its first
// copy, so no cp.async waits on a dependent global load.
//
// Semantics (those of the plain version and the Pallas kernel):
//  - keys past the table (pos[b] >= nb*ps) are not there: the row attends
//    keys up to nb*ps - 1 and nothing is written;
//  - otherwise the fused variant writes new_k/new_v at pos[b], into page
//    pt[b, pos[b] / ps], exactly once, by the block whose chunk holds
//    pos[b]; that block stages the row from new_k / new_v;
//  - page ids are clamped into [0, P-1];
//  - the engine keeps every live row's boundary page private (copy-on-write
//    at admission), so no block writes a page that another live row reads.
//    Free slots map every page to the TRASH page and write and read it
//    concurrently; their outputs are discarded, and no live row reads TRASH
//    at or below its pos.
//
// Still limited by the launch, one cp.async round per chunk and two
// cluster barriers (split_decode.cuh's note), and by an integer division by
// the runtime page size for each 16-byte piece it copies.
//
// Arithmetic follows the JAX package: q is scaled by hd^-0.5 before the dot,
// the softcap cap*tanh(s/cap) comes before masking, only live keys enter the
// softmax, the final division clamps l at 1e-37, the output is cast to q's
// dtype.  Loads are f32 or bf16 (template), accumulation is f32.  head_dim
// is 16, 32, 64, 96, 128 or 256.
#include "split_decode.cuh"

namespace {

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, T* __restrict__ kp, T* __restrict__ vp,
    const T* __restrict__ nk, const T* __restrict__ nv,
    const int* __restrict__ pos, T* __restrict__ out, int H, int K,
    int window, float scale, float cap, PagedKeys keys) {
  split_decode<T, HD>(q, kp, vp, nk, nv, pos, out, H, K, window, scale, cap,
                      keys);
}

template <typename T>
int launch(const void* q, void* k, void* v, const void* nk, const void* nv,
           const void* pt, const void* pos, void* out, int B, int H, int K,
           int P, int ps, int nb, int hd, int window, float scale, float cap,
           cudaStream_t stream) {
  const PagedKeys keys{static_cast<const int*>(pt), P, ps, nb, nullptr, 0};
  cudaError_t err = cudaSuccess;
  const int launched = launch_for_head_dim(hd, [&](auto head_dim) {
    constexpr int HD = decltype(head_dim)::value;
    err = launch_split<T, HD>(paged_attention_kernel<T, HD>, q, k, v, nk, nv,
                              pos, out, B, H, K, window, scale, cap, keys,
                              stream);
  });
  return err != cudaSuccess ? static_cast<int>(err) : launched;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {16, 32, 64, 96, 128, 256}.
// q (B,H,hd); k/v pools (P,ps,K,hd); nk/nv (B,K,hd); pt (B,nb) int32; pos
// (B,) int32; all contiguous, q, k, v, nk and nv 16-byte aligned.  nk == nv
// == NULL attends a pool that already holds the new row.  One launch: a
// cluster of min(8, ceil(nb*ps / CHUNK)) blocks per (slot, kv head), with
// nb page ids of shared memory a block.  Returns cudaGetLastError() after
// the launch.
extern "C" int paged_decode_attention(int dtype, const void* q, void* k,
                                      void* v, const void* nk,
                                      const void* nv, const void* pt,
                                      const void* pos, void* out, int B,
                                      int H, int K, int P, int ps, int nb,
                                      int hd, int window, float scale,
                                      float cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (dtype == 0)
    return launch<float>(q, k, v, nk, nv, pt, pos, out, B, H, K, P, ps, nb,
                         hd, window, scale, cap, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, nk, nv, pt, pos, out, B, H, K, P,
                                 ps, nb, hd, window, scale, cap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
