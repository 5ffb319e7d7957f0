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
// carries (m, l, acc) in VMEM scratch. Here one block of 128 threads owns
// 64 query rows of one (batch, head) and loops over 64-key tiles itself,
// with (m, l, acc) in registers. Thread (ty, tx) = (tid / 16, tid % 16)
// owns rows ty*8 .. ty*8+7; of the 64 x 64 score tile it computes columns
// tx + 16 j (j < 4), and of the 64 x d accumulator columns tx + 16 j
// (j < d / 16). Both products are register-tiled f32 FMA from shared
// memory: the Q tile (staged once) and the P tile are stored transposed so
// that a thread's 8 rows are two float4 loads, K transposed and V row-major
// so that the 16 column lanes read 16 consecutive words. A row's max and
// sum are reduced over its 16 lanes with warp shuffles. Head dim 256 runs
// 256 threads, (ty, tx) = (tid / 32, tid % 32): 2 score columns and 8
// accumulator columns a thread, so that the accumulator stays at 8 x 8
// registers (8 x 16 would spill), and a warp owns 8 whole rows. Its tiles
// take 214 KB of shared memory, one block per SM. The masked score is
// the finite NEG_INF = -1e30 of the TPU kernel, so exp never sees
// inf - inf, and its mass is set to 0 outright, as the ring step must
// (ring_fwd_step.cu): a row whose first tiles are wholly masked gains
// nothing there. Tiles wholly above the causal diagonal or wholly older
// than the window are never loaded (the loop bounds are _block_needed),
// which halves a causal prefill; tiles wholly inside the mask (all but the
// diagonal and the window's edge) skip the per-pair test, which took 14%
// of the forward's time at the bench.py LM's shapes. The ragged last tile is masked in the kernel, with no padded
// copy: rows past L are computed from zeros and not stored. The last q
// tiles, which have the most kv tiles under a causal mask, are scheduled
// first.
//
// Bound. With TF32 off the port's fp32 runs outside the tensor cores, so
// the bound is the work over the card's f32 FMA rate (67 TFLOP/s, H100
// SXM): 4 d flops per (query, key) pair the mask keeps, about 8.6 GFLOP
// -> 0.13 ms for a causal prefill at b 8, h 8, L 1024, d 64. The bytes
// (q, k, v read once, out and lse written once: 67 MB there, 0.02 ms) are
// far below it. Each thread issues 12 shared loads per 32 FMAs in the
// score product, so shared-memory traffic, the exp per score and the
// block-wide barriers per tile keep the kernel a small multiple above the
// bound; mma.sync / wgmma on bf16 inputs, TMA staging and a pipelined K/V
// ring are later work.

// The kernel body is flash_fwd.cuh, which ring_fwd_step.cu runs too; this
// file holds what only the flash forward does: the carry starts at
// (NEG_INF, 0, 0) and the row ends as out = acc / l and lse = m + log(l).
//
// Head dims: see flash_common.cuh (any d <= 256 in the next compiled
// width with zero-filled columns; above 256 in slices of 256 columns, the
// score product streamed over d in chunks, one more grid axis: at d 512
// two blocks per 64 query rows, each computing the whole 64 x 64 score
// tile).

#include "flash_fwd.cuh"

namespace {

using namespace flash;

// the flash forward's carry: it starts empty and ends normalised
template <typename T>
struct FlashFwdOut {
  T* out;      // (rows, sq, d), q's dtype
  float* lse;  // (rows, sq)

  template <int NA>
  __device__ __forceinline__ void init(int64_t, const int (&)[NA], int,
                                       float& m, float& l,
                                       float (&acc)[NA]) const {
    m = kNegInf;
    l = 0.f;
#pragma unroll
    for (int c = 0; c < NA; ++c) acc[c] = 0.f;
  }

  template <int NA>
  __device__ __forceinline__ void store(int64_t row, const int (&col)[NA],
                                        int d, bool stats, float m, float l,
                                        const float (&acc)[NA]) const {
    const float li = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < NA; ++c)
      if (col[c] < d) store_from_f32(out + row * d + col[c], acc[c] / li);
    if (stats) lse[row] = m + logf(li);
  }
};

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, void* out,
                float* lse, long long rows, const Geometry& g,
                cudaStream_t s) {
  return launch_fwd<T>(q, k, v, rows, g,
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
