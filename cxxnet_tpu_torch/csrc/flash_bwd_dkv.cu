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
// Design. One block owns 64 keys of one (batch, kv head). It loops over
// the h / nkv query heads that share the kv head and, for each, over the
// q tiles that _block_needed keeps: from the tile that holds the kv tile's
// diagonal to the end, clipped by the window (the forward's loop read the
// other way); kv tile 0, which feeds the most q tiles under a causal mask,
// is scheduled first. Each warp owns 16 of the keys. Every product runs on
// the tensor cores as m16n8k8 TF32 mma.sync (flash_mma.cuh states the
// fragment layouts):
//   S^T = K Q^T and dP^T = V dO^T: A = the warp's K / V rows, B = the Q /
//   dO tile, both read from row-major shared tiles with ldmatrix;
//   dV += P^T dO and dK += dS^T Q: A = P^T and dS^T straight from the
//   accumulator registers of S^T and dP^T (the C fragment read as an A
//   fragment in the k order (2t, 2t + 1)), B = dO / Q read at the matching
//   rows 8 j + 2t, 8 j + 2t + 1. P and dS never leave registers.
// The order within a tile is S^T, P^T, dV, then dP^T, dS^T, dK, so that
// S^T and dP^T are not both live beside the products' fragments: the
// order S^T, dP^T, P^T, dS^T, dV, dK spilled more and ran slower.
// fp32 operands are split in registers at fragment load (3xTF32,
// flash_mma.cuh), so shared memory holds each tile once. bf16 operands
// are exact in TF32: S^T and dP^T are one TF32 product of the bf16 words,
// dV and dK two (P^T and dS^T split, dO and Q exact), with the tiles bf16
// in shared memory (flash_bwd_dq.cu says why this route). dK and dV sum
// over the whole group's query rows: every pair of k-steps goes into a
// fresh accumulator and is added with one rounded f32 addition, as the
// tensor cores round toward zero (fed back as C, dK and dV drifted beyond
// the 1e-5 bar at L 2,048 on the card); S^T and dP^T,
// sums over at most 64 columns, go straight into their accumulators.
// K and V are copied once; Q, dO and the tile's lse and D stream through a
// ring of two stages of BQ query rows: the copy of the next tile (16-byte
// cp.async.cg, one commit group a tile) is in flight while the warps
// compute on this one, one barrier a tile. Query rows and keys past L and
// columns past d land as zeros through the copy's zero fill; rows that
// are not a multiple of 16 bytes take 4-byte copies, a bf16 tensor of odd
// head dim plain loads. Query rows at or past L contribute exactly
// nothing: their p is 0. A masked pair gets p = 0 outright; a tile wholly
// inside the mask skips the per-pair test. dK and dV are accumulated in
// registers over the whole group and written once. Departure from the JAX
// package, on purpose: it writes dK/dV per query head and sums the group
// outside (:353-357, :384-385); the loop over the group inside the block
// needs no h / nkv-times buffer, no reduction afterwards and no atomics,
// so a backward is bitwise repeatable.
//
// Per width (fp32 shared memory; bf16 a little over half):
//   d <= 64 (widths 16, 32, 64): BQ 64, 4 warps, 2 stages; 31 / 55 /
//     103 KB, two blocks an SM at width 64 (255 registers a thread and a
//     small spill; 32-row tiles spill nothing but re-split the K and V
//     fragments twice as often and ran slower)
//   128: BQ 16, 4 warps, 2 stages, 99 KB: two blocks an SM
//   256: BQ 32, 8 warps, one stage, 195 KB: two warps share each 16 keys,
//     each with 128 of the columns (so that dK and dV take 128 registers
//     and not 256), both computing the 16 x BQ scores: 12 d flops a pair
//     in place of 8. One stage of 32 rows ran faster than two of 16
//   above 256, in slices of 256 columns: the tiles of 256; every (query
//     row, q tile, 256-column chunk) restages K, V, Q and dO chunks, the
//     block's own chunk last, so that the stage holds its Q and dO for the
//     dV and dK products.
// Registers and spills per instantiation are in the build log (-Xptxas -v,
// chip_smoke.py prints them).
//
// Bound. 8 d flops per (query, key) pair the mask keeps (S, dV, dP, dK).
// In fp32 at the 3xTF32 rate of 495 / 3 = 165 TFLOP/s: for the bench.py
// LM's step (b 8, h 8, L 2048, d 64, causal) 134 M pairs, 68.7 GFLOP ->
// 0.416 ms (1.03 ms at the 67 TFLOP/s of fp32 FMA); in bf16, at 989
// TFLOP/s, 0.069 ms. The bytes (0.2 GB, 0.06 ms) are far below it. As in
// dQ, the issue of the instructions around the products (the splits of
// the B fragments, which every warp repeats for the shared Q and dO tile,
// the fresh accumulators, the exp) sets the time, not the tensor cores.
//
// The kernel body is flash_bwd_dkv_tc.cuh; this file holds what only the
// flash dK/dV does: both start at 0 and are stored once in the input
// dtype. ring_dkv_step.cu runs the same body with the ring's f32 carries
// in place, one query row a block.

#include "flash_bwd_dkv_tc.cuh"

namespace {

using namespace flash;

// the flash dK and dV: they start at 0 and are stored in k's dtype
template <typename T>
struct FlashDkvOut {
  T* dk;  // (kv_rows, skv, d)
  T* dv;
  static constexpr bool kInPlace = false;  // every block stores

  __device__ __forceinline__ void init(int64_t, int, int, float (&ak)[2],
                                       float (&av)[2]) const {
    ak[0] = ak[1] = av[0] = av[1] = 0.f;
  }

  __device__ __forceinline__ void store(int64_t row, int col, int d,
                                        const float (&ak)[2],
                                        const float (&av)[2]) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (col + i < d) {
        store_from_f32(dk + row * d + col + i, ak[i]);
        store_from_f32(dv + row * d + col + i, av[i]);
      }
    }
  }
};

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, long long rows, long long kv_rows,
                const Geometry& g, cudaStream_t s) {
  return launch_dkv_tc<T>(
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
