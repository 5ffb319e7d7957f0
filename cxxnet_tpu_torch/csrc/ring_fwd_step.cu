// One ring-attention step's online-softmax update, fp32 and bf16, for
// sm_90a.
//
// Replaces the TPU kernel _fwd_step_kernel (cxxnet_tpu/ops/ring_flash.py:83,
// launched by fwd_step at :191, pallas_call at :207). A device of the ring
// holds its query shard q (rows, sq, d) and, at step t, the K/V block
// (kv_rows, skv, d) of device (idx - t) mod n; it folds that block into the
// f32 carry (m, l, acc) of its rows:
//
//   m' = max(m, rowmax S),  S = scale q k^T + mask
//   l' = l exp(m - m') + rowsum exp(S - m')
//   acc' = acc exp(m - m') + exp(S - m') v
//
// The mask compares global positions: query row i sits at q_off + i, key j
// at kv_off + j, with q_off = idx sq and kv_off = src skv; when causal it
// keeps key <= query and (window > 0) query - key < window. q row r reads
// k/v row r / (rows / kv_rows), so grouped k/v are read in place. Every sum
// is f32 whatever the input dtype.
//
// Design. The flash forward's tensor-core body (flash_fwd_tc.cuh; its
// layout per width, fragments and bound in flash_fwd.cu), run with this
// file's IO policy:
//  - the carry crosses launches. Each block reads its rows' (m, l) and its
//    slice of acc from the previous step, in the C-fragment layout of its
//    warps (rows grp and grp + 8, columns 2t and 2t + 1 of each 8-column
//    tile), and writes them back; it never starts from (NEG_INF, 0, 0).
//    acc is updated in place (each block reads and writes only its own rows
//    and columns, as JAX aliases it); m and l go to separate outputs,
//    because above head dim 128 every slice's block reads the rows'
//    statistics while slice 0 writes them.
//  - masked mass is zeroed outright (_fwd_step_kernel, :111-114): the flash
//    kernel's old rule, p = 1 on a wholly masked leading tile rescaled to 0
//    by the first real key, would leave that mass in l between steps. So a
//    row none of whose keys in this block are kept ends the step with its
//    carry exactly as it was, and a step whose tiles are all masked skips
//    them all and copies (m, l) bitwise.
//  - the offsets are known only at launch, by value: each block computes
//    its own range of kv tiles from its rows' global start and the block's
//    (kv_tiles_for_q in flash_common.cuh) and loads no other. Under a causal
//    ring about half the steps of a device need no tile at all.
//  - one launch per (device, step), as JAX runs one call per device per
//    step: n^2 launches per layer and forward for a ring of n.
//
// Bound. 4 d flops per (query, key) pair the step's mask keeps, in fp32 at
// the 3xTF32 rate of 495 / 3 = 165 TFLOP/s (H100 SXM); the f32 carry (m, l
// and acc) is read and written once beside q, k and v. A step whose pairs
// are all masked has only its bytes: (m, l) read and written, the kernel's
// launch. For the long recipe's ring (2 x 8192 over 4 devices, 8 heads,
// d 64, window 1024) the diagonal step of a device keeps 1.6 M pairs per
// head; most other steps keep none.

#include "flash_fwd_tc.cuh"

namespace {

using namespace flash;

// the ring's carry: read from the previous step, written for the next
struct RingFwdCarry {
  const float* m_in;  // (rows, sq)
  const float* l_in;  // (rows, sq)
  float* m_out;       // (rows, sq)
  float* l_out;       // (rows, sq)
  float* acc;         // (rows, sq, d), updated in place

  __device__ __forceinline__ void init_stats(int64_t row, float& m,
                                             float& l) const {
    m = m_in[row];
    l = l_in[row];
  }

  __device__ __forceinline__ void init_acc(int64_t row, int col, int d,
                                           float (&a)[2]) const {
    if (col < d) a[0] = acc[row * d + col];
    if (col + 1 < d) a[1] = acc[row * d + col + 1];
  }

  __device__ __forceinline__ void store_acc(int64_t row, int col, int d,
                                            float,
                                            const float (&a)[2]) const {
    if (col < d) acc[row * d + col] = a[0];
    if (col + 1 < d) acc[row * d + col + 1] = a[1];
  }

  __device__ __forceinline__ void store_stats(int64_t row, float m,
                                              float l) const {
    m_out[row] = m;
    l_out[row] = l;
  }
};

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v); d >= 1; kv_rows divides
// rows; window > 0 only with causal. q (rows, sq, d), k, v (kv_rows, skv,
// d), m_in, l_in, m_out, l_out (rows, sq) f32, acc (rows, sq, d) f32, all
// contiguous; m_out, l_out must not alias m_in, l_in. q_off and kv_off are
// the global positions of q's row 0 and k's key 0. Returns the cudaError_t
// of the launch (0 = success). Launches on `stream` and does not
// synchronise.
int cxxnet_ring_fwd_step(const void* q, const void* k, const void* v,
                         const float* m_in, const float* l_in, float* m_out,
                         float* l_out, float* acc, int dtype, long long rows,
                         long long kv_rows, long long sq, long long skv,
                         int d, long long q_off, long long kv_off, int causal,
                         long long window, float scale, void* stream) {
  if (rows <= 0 || sq <= 0) return 0;
  if (kv_rows <= 0 || skv <= 0 || rows % kv_rows != 0)
    return (int)cudaErrorInvalidValue;
  const Geometry g{sq, skv, q_off, kv_off, (int)(rows / kv_rows), d, causal,
                   window, scale};
  const cudaError_t bad = check_geometry(rows, g);
  if (bad != cudaSuccess) return (int)bad;
  const RingFwdCarry io{m_in, l_in, m_out, l_out, acc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_fwd_tc<float>(q, k, v, rows, g, io, s);
  if (dtype == 1)
    return (int)launch_fwd_tc<__nv_bfloat16>(q, k, v, rows, g, io, s);
  return (int)cudaErrorInvalidValue;
}

const char* cxxnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
