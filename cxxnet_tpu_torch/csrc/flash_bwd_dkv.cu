// Flash attention backward, dK and dV, for (b, h, L, d) tensors, fp32 and
// bf16, for sm_90a.
//
// Replaces the TPU kernel _dkv_kernel (cxxnet_tpu/ops/flash_attn.py:156,
// launched by _flash_bwd at :363). With P = exp(scale q k^T + mask - lse)
// recomputed from the forward's lse, dP = dO v^T and D = rowsum(dO o)
// (computed before the launch), each key row of (batch, kv head) gets
//
//   dv = sum over its query heads of P^T dO
//   dk = sum over its query heads of scale * (P o (dP - D))^T q
//
// with the forward's mask. Every sum is f32 whatever the input dtype; dk
// and dv are stored in the input dtype, at kv-head resolution.
//
// Design. One block owns 64 keys of one (batch, kv head). It stages K^T
// and V^T once (transposed, so that a thread's 8 key rows are two float4
// loads) and loops over the h / nkv query heads that share the kv head and,
// for each, over the q tiles that _block_needed keeps: from the tile that
// holds the kv tile's diagonal to the end, clipped by the window (the
// forward's loop read the other way). Per q tile it stages Q and dO
// (row-major, rows padded to D + 1 words) and the tile's lse and D,
// computes S^T and dP^T for the thread's 8 keys x NC queries in one pass
// over the head dim, forms P and dS, writes both transposed to shared
// memory, and accumulates dV += P^T dO and dK += dS^T Q in registers
// (8 keys x D / TX columns each). dK and dV are written once. Departure
// from the JAX package, on purpose: it writes dK/dV per query head and
// sums the group outside (:353-357, :384-385); the loop over the group
// inside the block needs no h / nkv-times buffer, no reduction afterwards
// and no atomics, so a backward is bitwise repeatable. Query rows at or
// past L contribute exactly nothing: their p is set to 0 and their lse is
// never read (JAX gets this from zero-padded dO). A masked pair gets p = 0
// outright, so exp never sees NEG_INF; a tile wholly inside the mask skips
// the per-pair test. Head dim 128 runs 256 threads (32
// column lanes) so that dK and dV stay at 2 x 8 x 4 registers. Head dim 256
// gives a block 32 keys (4 row groups) and 64 column lanes, again 256
// threads and 2 x 8 x 4 accumulator registers: at 64 keys its K^T, V^T,
// Q, dO, P^T and dS^T tiles would take 299 KB of shared memory, over the
// 227 KB a block may opt into; at 32 they take 219 KB.
//
// Bound. 8 d flops per (query, key) pair the mask keeps (S, dV, dP, dK),
// at 67 TFLOP/s fp32: for the bench.py LM's step (b 8, h 8, L 2048, d 64,
// causal) 134 M pairs, 68.7 GFLOP -> 1.03 ms; the bytes (0.2 GB, 0.06 ms)
// are far below it. The S/dP pass issues 12 shared loads per 64 FMAs per
// thread, the dV/dK pass 4 + 2 D/TX per 16 D/TX, plus an exp per score
// and three barriers per q tile.
//
// The kernel body is flash_bwd_dkv.cuh, which ring_dkv_step.cu runs too;
// this file holds what only the flash dK/dV does: both start at 0 and are
// stored once in the input dtype. A head dim above 256 runs in slices of
// 256 dK/dV columns (flash_common.cuh): each slice's block streams the
// S / dP pass over the whole head dim in chunks of 256, K^T and V^T
// restaged per chunk, its own chunk of Q and dO last.

#include "flash_bwd_dkv.cuh"

namespace {

using namespace flash;

// the flash dK and dV: they start at 0 and are stored in k's dtype
template <typename T>
struct FlashDkvOut {
  T* dk;  // (kv_rows, skv, d)
  T* dv;

  template <int NA>
  __device__ __forceinline__ void init(int64_t, const int (&)[NA], int,
                                       float (&ak)[NA],
                                       float (&av)[NA]) const {
#pragma unroll
    for (int c = 0; c < NA; ++c) ak[c] = av[c] = 0.f;
  }

  template <int NA>
  __device__ __forceinline__ void store(int64_t row, const int (&col)[NA],
                                        int d, const float (&ak)[NA],
                                        const float (&av)[NA]) const {
#pragma unroll
    for (int c = 0; c < NA; ++c) {
      if (col[c] < d) {
        store_from_f32(dk + row * d + col[c], ak[c]);
        store_from_f32(dv + row * d + col[c], av[c]);
      }
    }
  }
};

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, long long rows, long long kv_rows,
                const Geometry& g, cudaStream_t s) {
  return launch_dkv<T>(
      q, k, v, dout, lse, delta, rows, kv_rows, g,
      FlashDkvOut<T>{static_cast<T*>(dk), static_cast<T*>(dv)}, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dk, dv); d >= 1;
// kv_heads divides heads; window > 0 only with causal. q, dout (batch,
// heads, L, d), k, v, dk, dv (batch, kv_heads, L, d), lse and delta (batch,
// heads, L) f32, all contiguous. Returns the cudaError_t of the launch
// (0 = success). Launches on `stream` and does not synchronise.
int cxxnet_flash_bwd_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int dtype,
                         long long batch, int heads, int kv_heads,
                         long long L, int d, int causal, long long window,
                         float scale, void* stream) {
  if (batch <= 0 || L <= 0) return 0;
  if (heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  const Geometry g{L, L, 0, 0, heads / kv_heads, d, causal, window, scale};
  const long long rows = batch * heads, kv_rows = batch * kv_heads;
  const cudaError_t bad = check_geometry(rows, g);
  if (bad != cudaSuccess) return (int)bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run<float>(q, k, v, dout, lse, delta, dk, dv, rows, kv_rows,
                           g, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, rows,
                                   kv_rows, g, s);
  return (int)cudaErrorInvalidValue;
}

const char* cxxnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
