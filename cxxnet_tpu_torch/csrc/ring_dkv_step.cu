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
// Design. The flash dK/dV's tensor-core body (flash_bwd_dkv_tc.cuh; its
// layout per width, fragments and rounding in flash_bwd_dkv.cu), run with
// this file's IO policy:
//  - the carries cross launches and devices. Each block starts dK and dV
//    of its 64 keys and slice from the f32 carries, read in the
//    C-fragment layout of its warps (keys grp and grp + 8, columns 2t and
//    2t + 1 of each 8-column tile), and writes them back in place. Grouped
//    K/V are read in place through the row map (JAX expands them to the
//    query heads for each call, cxxnet_tpu/parallel/ring.py:279-285).
//  - the tensor cores round their sums toward zero, and n launches add to
//    each carry: every pair of k-steps of P^T dO and dS^T Q is summed in a
//    fresh accumulator and reaches the carry by one rounded f32 addition,
//    never as the mma's C.
//  - departure from the flash dK/dV, which sums a kv head's group in one
//    block: here a block serves one query row (rows_per_block 1), h / nkv
//    times the blocks. A ring shard is short: 2048 keys of 2 kv heads at
//    batch 2 give 128 blocks of 64 keys, under one per SM, when the group
//    is summed in the block (the SIMT body this step ran before took 6.9
//    ms a layer that way against 3.6 ms at query-head resolution). So the
//    carries stay at query-head resolution, and parallel/ring.py sums each
//    group once, after the ring (JAX sums after every step, :330-333).
//  - the offsets come by value at launch and each block walks only the q
//    tiles its keys feed (q_tiles_for_kv, flash_common.cuh). A tile wholly
//    inside the mask skips the per-pair test at any offset, the others
//    take it. A block that feeds none returns before it reads its carries
//    (kInPlace), which stay bitwise as they were.
//  - no atomics: the step is bitwise repeatable. One launch per (device,
//    step): n^2 per layer and backward.
//
// Bound. 8 d flops per (query, key) pair the step's mask keeps (S, P^T dO,
// dP, dS^T Q), in fp32 at the 3xTF32 rate of 495 / 3 = 165 TFLOP/s (H100
// SXM), in bf16 at 989 TFLOP/s; the bytes (q, dO, k, v, lse, D read once,
// the carries read and written) are far below that whenever a tile is
// kept. A step that keeps no pair has only its launch.

#include "flash_bwd_dkv_tc.cuh"

namespace {

using namespace flash;

// the ring's dK / dV carries, f32, read and written in place
struct RingDkvCarry {
  float* dk;  // (rows, skv, d)
  float* dv;
  static constexpr bool kInPlace = true;

  __device__ __forceinline__ void init(int64_t row, int col, int d,
                                       float (&ak)[2], float (&av)[2]) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (col + i < d) {
        ak[i] = dk[row * d + col + i];
        av[i] = dv[row * d + col + i];
      }
    }
  }

  __device__ __forceinline__ void store(int64_t row, int col, int d,
                                        const float (&ak)[2],
                                        const float (&av)[2]) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (col + i < d) {
        dk[row * d + col + i] = ak[i];
        dv[row * d + col + i] = av[i];
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
    return (int)launch_dkv_tc<float>(q, k, v, dout, lse, delta, rows,
                                     /*out_rows=*/rows, g, io, s);
  if (dtype == 1)
    return (int)launch_dkv_tc<__nv_bfloat16>(q, k, v, dout, lse, delta, rows,
                                             /*out_rows=*/rows, g, io, s);
  return (int)cudaErrorInvalidValue;
}

const char* cxxnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
