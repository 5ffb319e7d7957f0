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
// Design. One block owns 64 query rows of one (batch, head) and loops over
// the kv tiles _block_needed keeps, the last q tiles (the most kv tiles
// under a causal mask) scheduled first. Each of its 4 warps owns 16 rows.
// Every product runs on the tensor cores as m16n8k8 TF32 mma.sync
// (flash_mma.cuh states the fragment layouts):
//   S = Q K^T and dP = dO V^T: A = the warp's Q / dO rows, B = the K / V
//   tile, both read from row-major shared tiles with ldmatrix (rows padded
//   by 16 bytes: the 8 rows of a ldmatrix hit 8 distinct bank groups);
//   dQ += dS K: A = dS straight from S's accumulator registers (the C
//   fragment read as an A fragment in the k order (2t, 2t + 1)), B = K read
//   at the matching rows 8 j + 2t, 8 j + 2t + 1 (conflict-free with the
//   same padding). P and dS never leave registers.
// fp32 operands are split in registers at fragment load, big = rna(x) and
// small = x - big, and each product is three TF32 products (3xTF32,
// flash_mma.cuh), so shared memory holds each tile once, as fp32. bf16
// operands are exact in TF32: S and dP are one TF32 product of the bf16
// words and dQ two (dS split, K exact), with the tiles bf16 in shared
// memory. That route keeps one fragment layout for both dtypes and forms
// every product of bf16 inputs exactly, where a bf16 mma would round P
// and dS to bf16; bf16 products on the bf16 tensor-core rate are later
// work.
// The tensor cores round their sums toward zero. Fed back as the mma's C
// over a whole sequence, dQ drifted toward zero beyond the 1e-5 bar at
// L 2,048 on the card; so dQ takes every pair of
// k-steps (6 products) in a fresh accumulator and adds it with one
// rounded f32 addition, while S and dP, sums over at most 64 columns
// (24 products), go straight into their accumulators (within 24 ulps).
// Q and dO are copied once; K and V stream through a ring of two stages
// of BK keys: the copy of tile j + 1 (16-byte cp.async.cg, one commit
// group a tile) is in flight while the warps compute on tile j, one
// barrier a tile. Keys and query rows past L and columns past d land as
// zeros through the copy's zero fill (src-size 0), so every product over
// them adds exact zeros; rows that are not a multiple of 16 bytes take
// 4-byte copies, and a bf16 tensor of odd head dim plain loads. A masked
// (query, key) gets p = 0 outright; a tile wholly inside the mask skips
// the per-pair test. dQ is accumulated in registers over every tile and
// written once. No atomics: a backward is bitwise repeatable.
//
// Per width (fp32 shared memory; bf16 a little over half):
//   d <= 64 (widths 16, 32, 64): BK 32, 2 stages; 20 / 36 / 68 KB, three
//     blocks an SM at width 64 (130 registers a thread, no spill)
//   128: BK 16, 2 stages, 99 KB: two blocks an SM
//   256: BK 32, one stage, 195 KB: Q and dO alone take 130 KB; one stage
//     of 32 keys ran faster than two of 16, whose every tile re-splits
//     the Q and dO fragments for half the keys
//   above 256, in slices of 256 columns: the tiles of 256; every (kv tile,
//     256-column chunk) restages Q, dO, K and V chunks, the block's own
//     slice last, so that the stage holds its K for the dQ product.
// Registers and spills per instantiation are in the build log (-Xptxas -v,
// chip_smoke.py prints them).
//
// Bound. 6 d flops per (query, key) pair the mask keeps (S, dP, dQ). In
// fp32 the tensor cores reach fp32 accuracy at 495 / 3 = 165 TFLOP/s
// (3xTF32): for the bench.py LM's step (b 8, h 8, L 2048, d 64, causal)
// 134 M pairs, 51.6 GFLOP -> 0.313 ms (0.77 ms at the 67 TFLOP/s of fp32
// FMA); in bf16, at 989 TFLOP/s, 0.052 ms. The bytes (q, k, v, dO, lse, D
// read once, dq written once: 0.17 GB, 0.05 ms) are far below it. What
// the kernel spends beyond the products is the issue of the instructions
// around them: per 8 x 8 x 8 step of the dQ product a lane loads and
// splits two B values (three instructions each) and adds the fresh
// accumulator, beside the three mma, and per score an exp.
//
// The kernel body is flash_bwd_dq_tc.cuh; this file holds what only the
// flash dQ does: dQ starts at 0 and is stored once in the input dtype.
// ring_dq_step.cu runs the same body with the ring's f32 carry in place.

#include "flash_bwd_dq_tc.cuh"

namespace {

using namespace flash;

// the flash dQ: it starts at 0 and is stored in q's dtype
template <typename T>
struct FlashDqOut {
  T* dq;  // (rows, sq, d)
  static constexpr bool kInPlace = false;  // every block stores

  __device__ __forceinline__ void init(int64_t, int, int,
                                       float (&acc)[2]) const {
    acc[0] = acc[1] = 0.f;
  }

  __device__ __forceinline__ void store(int64_t row, int col, int d,
                                        const float (&acc)[2]) const {
    if (col < d) store_from_f32(dq + row * d + col, acc[0]);
    if (col + 1 < d) store_from_f32(dq + row * d + col + 1, acc[1]);
  }
};

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dq, long long rows, const Geometry& g, cudaStream_t s) {
  return launch_dq_tc<T>(q, k, v, dout, lse, delta, rows, g,
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
