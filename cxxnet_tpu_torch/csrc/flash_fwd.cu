// Flash attention forward for (b, h, L, d) tensors, fp32 and bf16, for sm_90a.
//
// Replaces the TPU kernel _fwd_kernel (cxxnet_tpu/ops/flash_attn.py:82,
// launched by _flash_fwd at :284), with its masking and tile skipping
// (_mask, _block_needed, :49-79) and its grouped-query row map
// (_kv_row_map, :257-265). For q (b, h, L, d) and k, v (b, nkv, L, d) with
// nkv | h, each query row of (batch, head) computes
//
//   out = softmax(scale * q k^T + mask) v,   lse = m + log(l)
//
// against kv head h / (h / nkv), with no broadcast copy of k or v. The mask
// keeps key positions < L and, when causal, qpos >= kpos and (window > 0)
// qpos - kpos < window. Every sum is f32 whatever the input dtype; out is
// stored in the input dtype and lse, the per-row logsumexp the backward
// will recompute P from, in f32 as (b, h, L).
//
// Design. The TPU walks the kv tiles as the last, sequential grid axis and
// carries (m, l, acc) in VMEM scratch. Here one block of 4 warps owns 64
// query rows of one (batch, head) and loops over the kv tiles
// _block_needed keeps, the last q tiles (the most kv tiles under a causal
// mask) scheduled first. Each warp owns 16 of the rows and carries their
// (m, l, acc) in registers. Both products run on the tensor cores as
// m16n8k8 TF32 mma.sync (flash_mma.cuh states the fragment layouts):
//   S = Q K^T: A = the warp's Q rows, B = the K tile, both read from
//   row-major shared tiles with ldmatrix (rows padded by 16 bytes: the 8
//   rows of a ldmatrix hit 8 distinct bank groups);
//   acc += P V: A = P straight from S's accumulator registers (the C
//   fragment read as an A fragment in the k order (2t, 2t + 1)), B = V read
//   at the matching rows 8 j + 2t, 8 j + 2t + 1. P never leaves registers.
// A row's max and sum are reduced over the 4 lanes of its row group with
// __shfl_xor_sync. fp32 operands are split in registers at fragment load,
// big = rna(x) and small = x - big, and each product is three TF32
// products (3xTF32), so shared memory holds each tile once, as fp32. bf16
// operands are exact in TF32: S is one TF32 product of the bf16 words and
// P V two (P split, V exact), with the tiles bf16 in shared memory. P stays
// in f32 (split), as flash_fwd_ref keeps it, where the TPU kernel rounds it
// to v's dtype (cxxnet_tpu/ops/flash_attn.py:114); a bf16 P V on the bf16
// tensor-core rate is later work.
// The tensor cores round their sums toward zero, so a long sum fed back as
// the mma's C drifts toward zero. P V sums over the whole sequence: each
// pair of k-steps (6 products) goes into a fresh accumulator and reaches
// acc, rescaled by alpha = exp(m - m_new) first, by one rounded f32
// addition. S, a sum over at most 128 head-dim columns a block, takes a
// fresh accumulator per pair of k-steps too in fp32: summed straight into
// its accumulator (within 24 ulps of the score over 64 columns, as the
// backward does) it missed this kernel's bar of 8 f32 epsilons of the
// largest |out| on the card. In bf16 a k-step is one exact TF32 product,
// summed straight in.
// K and V stream through a cp.async ring (16-byte cp.async.cg, one commit
// group a tile); Q is copied once per block. Keys and query rows past L
// and columns past d land as zeros through the copy's zero fill, so every
// product over them adds exact zeros; rows that are not a multiple of 16
// bytes take 4-byte copies, a bf16 tensor of odd head dim plain loads. The
// masked score is the finite NEG_INF = -1e30 of the TPU kernel, so exp
// never sees inf - inf, and its mass is set to 0 outright, as the ring
// step must (ring_fwd_step.cu): a row whose first tiles are wholly masked
// gains nothing there. Tiles wholly inside the mask skip the per-pair test
// (tile_unmasked).
//
// Per width, with the registers a thread and the spills of the fp32
// instantiations from ptxas -v (the build log; chip_smoke.py prints every
// instantiation's, bf16 and the ring step within a few registers of these).
// Every kernel is bounded at two blocks an SM (__launch_bounds__): ptxas
// then keeps up to 255 registers; without the bound it kept fewer and the
// kernel ran slower, timed side by side.
//   d <= 64 (widths 16, 32, 64): 64-key tiles, 2 stages; 25 / 45 / 85 KB
//     of shared memory (bf16 about half); 153-161 / 195-203 / 247-254
//     registers, no spill: two blocks an SM
//   128: 32-key tiles, 2 stages, 99 KB; 255 registers, 44-56 B spilled:
//     two blocks an SM
//   above 128: slices of 128 output columns, one block each (grid z), the
//     slices of one q tile in a thread-block cluster of up to 8
//     (fwd_cluster: the largest divisor of the slice count up to 8). Each
//     block stages Q, K and V of its own 128 columns only and forms the
//     partial score over them; the partial scores meet through distributed
//     shared memory (two exchange buffers of 8 KB, one cluster barrier a
//     kv tile) and every block sums them in rank order, so that all hold
//     the same S and the same row statistics. The score product is thus
//     formed once per (q tile, kv tile), split over the cluster, not once
//     per slice, and Q is staged once. 32-key tiles, one stage in fp32
//     (82 KB: two blocks an SM), two in bf16 (67 KB); 255 registers, 36 B
//     spilled. A head dim of more
//     than 8 slices whose count has no divisor in 2..8 (d above 1,024)
//     runs clusters of fewer blocks, each forming its scores over several
//     chunks and restaging Q with each (one stage; 255 registers, 16 B).
//
// Bound. 4 d flops per (query, key) pair the mask keeps (S and P V). In
// fp32 the tensor cores reach fp32 accuracy at 495 / 3 = 165 TFLOP/s
// (3xTF32): a causal prefill at b 8, h 8, L 1024, d 64 keeps 33.6 M pairs,
// 8.6 GFLOP -> 0.052 ms (0.128 ms at the 67 TFLOP/s of fp32 FMA); in
// bf16, at 989 TFLOP/s, 0.009 ms. The bytes (q, k, v read once, out and
// lse written once: 67 MB there, 0.02 ms) are below it. What the kernel
// spends beyond the products is the issue of the instructions around them
// and their latency with 8 warps an SM: the split of every fragment (Q and
// K afresh for each kv tile, each warp splitting the shared K and V tiles
// again), the fresh accumulators, an exp per score, a cluster barrier a
// kv tile above 128; wgmma, TMA and warp specialisation are later work.
//
// The kernel body is flash_fwd_tc.cuh, which ring_fwd_step.cu runs too;
// this file holds what only the flash forward does: the carry starts at
// (NEG_INF, 0, 0) and the row ends as out = acc / l and lse = m + log(l).

#include "flash_fwd_tc.cuh"

namespace {

using namespace flash;

// the flash forward's carry: it starts empty and ends normalised
template <typename T>
struct FlashFwdOut {
  T* out;      // (rows, sq, d), q's dtype
  float* lse;  // (rows, sq)

  // the kernel's own start: (m, l) = (NEG_INF, 0) and acc 0
  __device__ __forceinline__ void init_stats(int64_t, float&, float&) const {}
  __device__ __forceinline__ void init_acc(int64_t, int, int,
                                           float (&)[2]) const {}

  __device__ __forceinline__ void store_acc(int64_t row, int col, int d,
                                            float l,
                                            const float (&a)[2]) const {
    const float li = fmaxf(l, 1e-30f);
    if (col < d) store_from_f32(out + row * d + col, a[0] / li);
    if (col + 1 < d) store_from_f32(out + row * d + col + 1, a[1] / li);
  }

  __device__ __forceinline__ void store_stats(int64_t row, float m,
                                              float l) const {
    lse[row] = m + logf(fmaxf(l, 1e-30f));
  }
};

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, void* out,
                float* lse, long long rows, const Geometry& g,
                cudaStream_t s) {
  return launch_fwd_tc<T>(q, k, v, rows, g,
                          FlashFwdOut<T>{static_cast<T*>(out), lse}, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; d >= 1; kv_heads divides heads;
// window > 0 only with causal. q, out (batch, heads, L, d), k, v (batch,
// kv_heads, L, d), lse (batch, heads, L) f32, all contiguous. Returns the
// cudaError_t of the launch (0 = success). Launches on `stream` and does
// not synchronise.
int cxxnet_flash_fwd(const void* q, const void* k, const void* v, void* out,
                     float* lse, int dtype, long long batch, int heads,
                     int kv_heads, long long L, int d, int causal,
                     long long window, float scale, void* stream) {
  if (batch <= 0 || L <= 0) return 0;
  if (heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  const Geometry g{L, L, 0, 0, heads / kv_heads, d, causal, window, scale};
  const long long rows = batch * heads;
  const cudaError_t bad = check_geometry(rows, g);
  if (bad != cudaSuccess) return (int)bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run<float>(q, k, v, out, lse, rows, g, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(q, k, v, out, lse, rows, g, s);
  return (int)cudaErrorInvalidValue;
}

const char* cxxnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
