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
// Design. The flash dQ body (flash_bwd_dq.cuh; its layout and register
// tiling in flash_bwd_dq.cu), run with this file's IO policy: each block
// starts from its rows' and slice's dQ carry and writes it back in place
// (it reads and writes only its own rows and columns, as JAX aliases the
// carry). dQ stays on its device for the whole ring pass. The offsets come
// by value at launch and each block loads only the kv tiles its rows need
// (kv_tiles_for_q, flash_common.cuh); a block that needs none leaves its
// carry as it was. A masked pair gets p = 0 outright. No atomics: the
// step is bitwise repeatable. One launch per (device, step): n^2 per layer
// and backward for a ring of n.
//
// Bound. 6 d flops per (query, key) pair the step's mask keeps (S, dP,
// dS K) at the fp32 rate, 67 TFLOP/s; the bytes (q, dO, the block's k and
// v, lse and D read once, the carry read and written) are far below that
// at the ring's shapes whenever a tile is kept.

#include "flash_bwd_dq.cuh"

namespace {

using namespace flash;

// the ring's dQ carry, f32, read and written in place
struct RingDqCarry {
  float* dq;  // (rows, sq, d)

  template <int NA>
  __device__ __forceinline__ void init(int64_t row, const int (&col)[NA],
                                       int d, float (&acc)[NA]) const {
#pragma unroll
    for (int c = 0; c < NA; ++c)
      acc[c] = col[c] < d ? dq[row * d + col[c]] : 0.f;
  }

  template <int NA>
  __device__ __forceinline__ void store(int64_t row, const int (&col)[NA],
                                        int d, const float (&acc)[NA]) const {
#pragma unroll
    for (int c = 0; c < NA; ++c)
      if (col[c] < d) dq[row * d + col[c]] = acc[c];
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
    return (int)launch_dq<float>(q, k, v, dout, lse, delta, rows, g, io, s);
  if (dtype == 1)
    return (int)launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, rows, g,
                                         io, s);
  return (int)cudaErrorInvalidValue;
}

const char* cxxnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
