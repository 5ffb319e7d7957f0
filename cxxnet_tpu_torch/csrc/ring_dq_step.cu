// One ring-attention step's dQ contribution, fp32 and bf16, for sm_90a.
//
// Replaces the TPU kernel _dq_step_kernel (cxxnet_tpu/ops/ring_flash.py:121,
// launched by dq_step at :224, pallas_call at :235). In the backward's ring
// pass a device holds its query shard q and upstream gradient dO
// (rows, sq, d), the forward's lse and D = rowsum(dO o O) (rows, sq) f32,
// and at step t the K/V block of device (idx - t) mod n; it adds that
// block's share to its f32 dQ carry:
//
//   dq += scale (P o (dO v^T - D)) k,   P = exp(scale q k^T + mask - lse)
//
// with the ring forward's mask at the global positions q_off + i and
// kv_off + j (causal: key <= query, window > 0: query - key < window). q
// row r reads k/v row r / (rows / kv_rows): grouped k/v in place. Every
// sum is f32.
//
// Design. The flash dQ's tensor-core body (flash_bwd_dq_tc.cuh; its
// layout per width, fragments and rounding in flash_bwd_dq.cu), run with
// this file's IO policy:
//  - the carry crosses launches. Each block starts its accumulators from
//    its rows' and slice's f32 dQ carry, read in the C-fragment layout of
//    its warps (rows grp and grp + 8, columns 2t and 2t + 1 of each
//    8-column tile), and writes them back in place (each block reads and
//    writes only its own rows and columns, as JAX aliases the carry). dQ
//    stays on its device for the whole ring pass.
//  - the tensor cores round their sums toward zero, and up to n launches
//    add to one carry: every pair of k-steps of dS K is summed in a fresh
//    accumulator and reaches the carry by one rounded f32 addition, never
//    as the mma's C.
//  - the offsets are known only at launch, by value: each block computes
//    its own range of kv tiles from its rows' global start
//    (kv_tiles_for_q, flash_common.cuh) and loads no other. A tile wholly
//    inside the mask skips the per-pair test at any offset, the others
//    take it, and a masked pair gets p = 0 outright. A block that keeps no
//    tile returns before it reads its carry (kInPlace), which stays
//    bitwise as it was; under a causal ring about half the steps of a
//    device keep none.
//  - no atomics: the step is bitwise repeatable. One launch per (device,
//    step): n^2 per layer and backward for a ring of n.
//
// Bound. 6 d flops per (query, key) pair the step's mask keeps (S, dP,
// dS K), in fp32 at the 3xTF32 rate of 495 / 3 = 165 TFLOP/s (H100 SXM),
// in bf16 at 989 TFLOP/s; the bytes (q, dO, the block's k and v, lse and
// D read once, the carry read and written) are far below that at the
// ring's shapes whenever a tile is kept. A step that keeps no pair has
// only its launch.

#include "flash_bwd_dq_tc.cuh"

namespace {

using namespace flash;

// the ring's dQ carry, f32, read and written in place
struct RingDqCarry {
  float* dq;  // (rows, sq, d)
  static constexpr bool kInPlace = true;

  __device__ __forceinline__ void init(int64_t row, int col, int d,
                                       float (&acc)[2]) const {
    if (col < d) acc[0] = dq[row * d + col];
    if (col + 1 < d) acc[1] = dq[row * d + col + 1];
  }

  __device__ __forceinline__ void store(int64_t row, int col, int d,
                                        const float (&acc)[2]) const {
    if (col < d) dq[row * d + col] = acc[0];
    if (col + 1 < d) dq[row * d + col + 1] = acc[1];
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout); d >= 1; kv_rows
// divides rows; window > 0 only with causal. q, dout (rows, sq, d), k, v
// (kv_rows, skv, d), lse and delta (rows, sq) f32, dq (rows, sq, d) f32
// updated in place, all contiguous. q_off and kv_off are the global
// positions of q's row 0 and k's key 0. Returns the cudaError_t of the
// launch (0 = success). Launches on `stream` and does not synchronise.
int cxxnet_ring_dq_step(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, float* dq, int dtype,
                        long long rows, long long kv_rows, long long sq,
                        long long skv, int d, long long q_off,
                        long long kv_off, int causal, long long window,
                        float scale, void* stream) {
  if (rows <= 0 || sq <= 0) return 0;
  if (kv_rows <= 0 || skv <= 0 || rows % kv_rows != 0)
    return (int)cudaErrorInvalidValue;
  const Geometry g{sq, skv, q_off, kv_off, (int)(rows / kv_rows), d, causal,
                   window, scale};
  const cudaError_t bad = check_geometry(rows, g);
  if (bad != cudaSuccess) return (int)bad;
  const RingDqCarry io{dq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dq_tc<float>(q, k, v, dout, lse, delta, rows, g,
                                    io, s);
  if (dtype == 1)
    return (int)launch_dq_tc<__nv_bfloat16>(q, k, v, dout, lse, delta, rows,
                                            g, io, s);
  return (int)cudaErrorInvalidValue;
}

const char* cxxnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
