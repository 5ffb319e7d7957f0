// Flash attention backward, dQ, for (b, h, L, d) tensors, fp32 and bf16,
// for sm_90a.
//
// Replaces the TPU kernel _dq_kernel (cxxnet_tpu/ops/flash_attn.py:123,
// launched by _flash_bwd at :337). With P = exp(scale q k^T + mask - lse)
// recomputed from the forward's lse, dP = dO v^T and D = rowsum(dO o)
// (computed before the launch, as the JAX package computes it outside its
// kernels), each query row of (batch, head) gets
//
//   dq = scale * (P o (dP - D)) k
//
// against kv head h / (h / nkv), with the mask of the forward (keys < L;
// when causal, qpos >= kpos and (window > 0) qpos - kpos < window). Every
// sum is f32 whatever the input dtype; dq is stored in the input dtype.
//
// Design. The forward's layout (flash_fwd.cu): one block owns 64 query
// rows of one (batch, head) and loops over the 64-key tiles _block_needed
// keeps, the same loop bounds as the forward. Q and dO are staged once,
// transposed, so that a thread's 8 rows are two float4 loads; lse and D
// of its rows sit in registers. Per kv tile the block stages K^T and V^T,
// recomputes the 64 x 64 scores and dP in one pass over the head dim
// (thread (ty, tx) owns rows ty*8 .. ty*8+7 and columns tx + TX j), forms
// dS = P (dP - D) scale in registers, writes it transposed to shared
// memory, and accumulates dQ += dS K in registers (columns tx + TX c of
// the head dim, K read from the same transposed tile: the lanes read a
// stride of 65 words, 32 distinct banks). dQ is written once. A masked
// (query, key) gets p = 0 outright, so a wholly masked tile adds exact
// zeros and exp never sees NEG_INF; a tile wholly inside the mask skips
// the per-pair test. The ragged last tiles are masked in
// place: keys and query rows past L are staged as zeros and rows past L
// are never stored. No atomics: a backward is bitwise repeatable. The
// last q tiles, which have the most kv tiles under a causal mask, are
// scheduled first. Head dim 128 runs 256 threads (32 column lanes) so
// that the accumulators stay at 4 x 8 registers. Head dim 256 keeps the 32
// lanes (8 x 8 accumulator registers) and halves the key tile to 32: at 64
// keys its Q^T, dO^T, K^T, V^T and dS^T tiles would take 283 KB of shared
// memory, over the 227 KB a block may opt into; at 32 they take 211 KB.
//
// Bound. With TF32 off the port's fp32 runs outside the tensor cores: 6 d
// flops per (query, key) pair the mask keeps (S, dP, dQ), at 67 TFLOP/s.
// For the bench.py LM's step (b 8, h 8, L 2048, d 64, causal) that is
// 134 M pairs, 51.6 GFLOP -> 0.77 ms; the bytes (q, k, v, dO, lse, D read
// once, dq written once: 0.2 GB, 0.06 ms) are far below it. Per kv tile a
// thread issues 12 shared loads per 64 FMAs in the S/dP pass and 2 + D/TX
// per 8 D/TX in the dQ pass, plus an exp per score and three barriers;
// mma.sync / wgmma on bf16 inputs and a pipelined K/V ring are later work.
//
// The kernel body is flash_bwd_dq.cuh, which ring_dq_step.cu runs too;
// this file holds what only the flash dQ does: dQ starts at 0 and is
// stored once in the input dtype. A head dim above 256 runs in slices of
// 256 dQ columns (flash_common.cuh): each slice's block streams the S / dP
// pass over the whole head dim in chunks of 256, its own chunk last.

#include "flash_bwd_dq.cuh"

namespace {

using namespace flash;

// the flash dQ: it starts at 0 and is stored in q's dtype
template <typename T>
struct FlashDqOut {
  T* dq;  // (rows, sq, d)

  template <int NA>
  __device__ __forceinline__ void init(int64_t, const int (&)[NA], int,
                                       float (&acc)[NA]) const {
#pragma unroll
    for (int c = 0; c < NA; ++c) acc[c] = 0.f;
  }

  template <int NA>
  __device__ __forceinline__ void store(int64_t row, const int (&col)[NA],
                                        int d, const float (&acc)[NA]) const {
#pragma unroll
    for (int c = 0; c < NA; ++c)
      if (col[c] < d) store_from_f32(dq + row * d + col[c], acc[c]);
  }
};

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dq, long long rows, const Geometry& g, cudaStream_t s) {
  return launch_dq<T>(q, k, v, dout, lse, delta, rows, g,
                      FlashDqOut<T>{static_cast<T*>(dq)}, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dq); d >= 1; kv_heads
// divides heads; window > 0 only with causal. q, dout, dq (batch, heads, L,
// d), k, v (batch, kv_heads, L, d), lse and delta (batch, heads, L) f32,
// all contiguous. Returns the cudaError_t of the launch (0 = success).
// Launches on `stream` and does not synchronise.
int cxxnet_flash_bwd_dq(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dq, int dtype,
                        long long batch, int heads, int kv_heads, long long L,
                        int d, int causal, long long window, float scale,
                        void* stream) {
  if (batch <= 0 || L <= 0) return 0;
  if (heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  const Geometry g{L, L, 0, 0, heads / kv_heads, d, causal, window, scale};
  const long long rows = batch * heads;
  const cudaError_t bad = check_geometry(rows, g);
  if (bad != cudaSuccess) return (int)bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run<float>(q, k, v, dout, lse, delta, dq, rows, g, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, rows, g,
                                   s);
  return (int)cudaErrorInvalidValue;
}

const char* cxxnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
