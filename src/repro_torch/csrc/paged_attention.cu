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
//
// Design: the TPU kernel ran an ordered grid (slot b, logical page j) with
// the page table as a scalar-prefetch operand dereferenced by the KV index
// map, and carried the online-softmax state in VMEM scratch.  Here the body
// is decode_attention.cu's (attend_keys in attention_common.cuh, templated
// on the address of a key's row): one block owns one (slot b, kv head k) and
// loops over that row's live keys [lo_b, pos[b]] itself; each warp owns one
// q head of the group G = H/K, lanes split head_dim, dot products reduce
// with warp shuffles and the online softmax runs in f32 per warp.  Only the
// address of a key changes: logical key t is row t % ps of physical page
// pt[b, t / ps], so a 16-key chunk may span pages (ps is a runtime value),
// and each lane reads the page id of each key of its chunk from the table
// (the same word for all lanes: one broadcast load, cached).  Keys of a
// chunk are loaded before any is used, so a chunk costs one memory round
// trip.  The fused variant first writes new_k/new_v at pos[b] into page
// pt[b, pos[b] / ps] (nothing when pos[b] / ps >= nb, as the Pallas index
// map), then __syncthreads, which makes the block's global writes visible
// to its own reads, so the self term reads the new row.  The engine keeps
// every live row's boundary page private (copy-on-write at admission), so
// no block writes a page that another live row reads.  Free slots map
// every page to the TRASH page and write and read it concurrently; their
// outputs are discarded, and no live row reads TRASH at or below its pos.
//
// Known limit: one block per (b, k), B*K = 64 blocks at 8 slots of
// llama3-8b on 132 SMs: under-filled and latency bound.  Split-K over
// pages (as decode_attention.cu now does over a dense row), TMA page
// gathers and wgmma for the grouped dot are later work.
//
// Arithmetic follows the JAX package: q is scaled by hd^-0.5 before the dot,
// the softcap cap*tanh(s/cap) comes before masking, only live keys enter the
// softmax, the final division clamps l at 1e-37, the output is cast to q's
// dtype.  Loads are f32 or bf16 (template), accumulation is f32.  head_dim
// is 16, 32, 64, 96, 128 or 256: lanes hold vectors of at most 16 bytes
// (Lanes in attention_common.cuh), idle lanes masked.
#include "attention_common.cuh"

namespace {

template <typename T, int HD>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, T* __restrict__ kp, T* __restrict__ vp,
    const T* __restrict__ nk, const T* __restrict__ nv,
    const int* __restrict__ pt, const int* __restrict__ pos,
    T* __restrict__ out, int H, int K, int P, int ps, int nb, int window,
    float scale, float cap) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int p = pos[b];
  // keys past the table (p >= nb * ps) are not there: attend the table's
  // last key, as the Pallas kernel's clamped grid does
  const int last = min(p, nb * ps - 1);
  const int lo = window > 0 ? max(p - window + 1, 0) : 0;
  const int* ptb = pt + (size_t)b * nb;
  const size_t stride = (size_t)K * HD;  // elements between page rows
  const size_t head = (size_t)kh * HD;
  // a page id outside the pool is clamped, so that no launch can read or
  // write outside it; the engine never maps one
  auto row = [=](int t) {
    const int page = min(max(ptb[t / ps], 0), P - 1);
    return ((size_t)page * ps + t % ps) * stride + head;
  };
  attend_keys<T, HD>(q, kp, vp, nk, nv, out, b, kh, H, K,
                      nk != nullptr && p >= 0 && p / ps < nb, p, lo, last,
                      row, scale, cap);
}

template <typename T>
int launch(const void* q, void* k, void* v, const void* nk, const void* nv,
           const void* pt, const void* pos, void* out, int B, int H, int K,
           int P, int ps, int nb, int hd, int window, float scale, float cap,
           cudaStream_t stream) {
  return launch_for_head_dim(hd, [&](auto head_dim) {
    paged_attention_kernel<T, decltype(head_dim)::value>
        <<<dim3(K, B), dim3(32 * (H / K)), 0, stream>>>(
            static_cast<const T*>(q), static_cast<T*>(k),
            static_cast<T*>(v), static_cast<const T*>(nk),
            static_cast<const T*>(nv), static_cast<const int*>(pt),
            static_cast<const int*>(pos), static_cast<T*>(out), H, K, P, ps,
            nb, window, scale, cap);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd in {16, 32, 64, 96, 128, 256}.
// q (B,H,hd);
// k/v pools (P,ps,K,hd); pt (B,nb) int32; pos (B,) int32.  nk == nv == NULL
// attends a pool that already holds the new row.  Returns
// cudaGetLastError() after the launch.
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
