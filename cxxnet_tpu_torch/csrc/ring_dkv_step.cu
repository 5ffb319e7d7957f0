// One ring-attention step's dK/dV contribution, fp32 and bf16, for sm_90a.
//
// Replaces the TPU kernel _dkv_step_kernel (cxxnet_tpu/ops/ring_flash.py:150,
// launched by dkv_step at :248, pallas_call at :261). In the backward's ring
// pass a K/V block (kv_rows, skv, d) travels around the ring together with
// its f32 gradient carries dk and dv (rows, skv, d), at query-head
// resolution as JAX keeps them; at each step the device holding it adds
// the share of its own queries q, upstream gradient dO (rows, sq, d), lse
// and D = rowsum(dO o O) (rows, sq):
//
//   dv += P^T dO,  dk += scale dS^T q,
//   P = exp(scale q k^T + mask - lse),  dS = P o (dO v^T - D)
//
// with the ring forward's mask at the global positions q_off + i and
// kv_off + j. After n steps every block is home with every device's share.
//
// Design. The flash dK/dV body (flash_bwd_dkv.cuh; its layout and register
// tiling in flash_bwd_dkv.cu), run with this file's IO policy: each block
// owns BK keys of one k/v row, keeps its K^T and V^T tiles resident while
// the q tiles of its query rows stream, and starts from and writes back
// its keys' and slice's carries, in place. Grouped K/V are read in place
// through the row map (JAX expands them to the query heads for each call,
// cxxnet_tpu/parallel/ring.py:279-285). Departure from the flash dK/dV,
// which sums a kv head's group in one block: here a block serves one query
// row (rows_per_block 1), h / nkv times the blocks. A ring shard is short
// (2048 keys of 2 kv heads at batch 2 give 128 blocks of 128 threads, one
// per SM, when the group is summed in the block; that ring took 6.9 ms a
// layer against 3.6 ms this way), so the carries stay at query-head
// resolution and parallel/ring.py sums each group once, after the ring
// (JAX sums after every step, :330-333). No atomics: the step is bitwise
// repeatable. The offsets come
// by value at launch and each block walks only the q tiles its keys feed
// (q_tiles_for_kv, flash_common.cuh); a block that feeds none leaves its
// carries as they were. One launch per (device, step): n^2 per layer and
// backward.
//
// Bound. 8 d flops per (query, key) pair the step's mask keeps (S, P^T dO,
// dP, dS^T Q) at the fp32 rate, 67 TFLOP/s; the bytes (q, dO, k, v, lse,
// D read once, the carries read and written) are far below that whenever
// a tile is kept.

#include "flash_bwd_dkv.cuh"

namespace {

using namespace flash;

// the ring's dK / dV carries, f32, read and written in place
struct RingDkvCarry {
  float* dk;  // (rows, skv, d)
  float* dv;

  template <int NA>
  __device__ __forceinline__ void init(int64_t row, const int (&col)[NA],
                                       int d, float (&ak)[NA],
                                       float (&av)[NA]) const {
#pragma unroll
    for (int c = 0; c < NA; ++c) {
      const bool in = col[c] < d;
      ak[c] = in ? dk[row * d + col[c]] : 0.f;
      av[c] = in ? dv[row * d + col[c]] : 0.f;
    }
  }

  template <int NA>
  __device__ __forceinline__ void store(int64_t row, const int (&col)[NA],
                                        int d, const float (&ak)[NA],
                                        const float (&av)[NA]) const {
#pragma unroll
    for (int c = 0; c < NA; ++c) {
      if (col[c] < d) {
        dk[row * d + col[c]] = ak[c];
        dv[row * d + col[c]] = av[c];
      }
    }
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout); d >= 1; kv_rows
// divides rows; window > 0 only with causal. q, dout (rows, sq, d), k, v
// (kv_rows, skv, d), lse and delta (rows, sq) f32, dk and dv (rows, skv, d)
// f32 updated in place, all contiguous. q_off and kv_off are the global
// positions of q's row 0 and k's key 0. Returns the cudaError_t of the
// launch (0 = success). Launches on `stream` and does not synchronise.
int cxxnet_ring_dkv_step(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, float* dk, float* dv, int dtype,
                         long long rows, long long kv_rows, long long sq,
                         long long skv, int d, long long q_off,
                         long long kv_off, int causal, long long window,
                         float scale, void* stream) {
  if (kv_rows <= 0 || skv <= 0) return 0;
  if (rows <= 0 || sq <= 0 || rows % kv_rows != 0)
    return (int)cudaErrorInvalidValue;
  const Geometry g{sq, skv, q_off, kv_off, (int)(rows / kv_rows), d, causal,
                   window, scale};
  const cudaError_t bad = check_geometry(rows, g);
  if (bad != cudaSuccess) return (int)bad;
  const RingDkvCarry io{dk, dv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dkv<float>(q, k, v, dout, lse, delta, rows, rows, g,
                                  io, s);
  if (dtype == 1)
    return (int)launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, rows,
                                          rows, g, io, s);
  return (int)cudaErrorInvalidValue;
}

const char* cxxnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
