// Shared pieces of the attention kernels: the flash kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu) and the ring steps (ring_fwd_step.cu,
// ring_dq_step.cu, ring_dkv_step.cu). Each direction has one tensor-core
// body that both run with other inputs and outputs: the forward
// flash_fwd_tc.cuh, the backward flash_bwd_dq_tc.cuh and
// flash_bwd_dkv_tc.cuh.
// Here: the query tile, the finite NEG_INF, the store from f32,
// the geometry of one launch, the mask at global positions, the
// tile ranges that _block_needed / _tile_needed keep
// (cxxnet_tpu/ops/flash_attn.py:66-79, cxxnet_tpu/ops/ring_flash.py:66-82),
// the compiled head widths and the dispatch over them.
//
// Head dims. The backward kernels are compiled for the widths 16, 32, 64,
// 128 and 256; a head dim d <= 256 runs in the smallest width W >= d. Loads
// zero-fill the columns d .. W-1 and stores skip them, so every dot product
// over the head dim gains only zero terms and the result is exact. Tensors
// keep their own row stride d. Width 256 takes a layout of its own in each
// backward body (one stage; 32-key tiles in the dQ, two warps to every 16
// keys in the dK/dV), so that its accumulators stay in registers and its
// tiles within the 227 KB of shared memory a block may opt into. The forward's widths stop at 128;
// above that it runs slices of 128 in thread-block clusters that share the
// score product (flash_fwd_tc.cuh).
//
// In the backward kernels a head dim above 256 runs in width 256 in
// slices: the output columns are cut into n_slices(d) slices of 256 (the
// last one zero-filled past d), one more grid axis, and a block owns one
// slice of the accumulator. The score-like products (S = Q K^T and
// dP = dO V^T) need the whole head dim: the block streams them over d in
// chunks of 256 columns through the same shared buffers the width-256
// layout has, so shared memory and registers stay those of width 256.
// Every slice recomputes the scores, ceil(d / 256) times the score work,
// and takes its own slice's chunk last, so that the chunk its dQ / dK / dV
// product reads is the one still staged.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

constexpr int kBQ = 64;          // query rows per tile (the dQ and forward)
constexpr int kMinTile = 32;     // the smallest tile any kernel's grid walks
constexpr float kNegInf = -1e30f;
constexpr int kSliceWidth = 256; // the widest compiled width; wider in slices

__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// What one launch computes over. q holds sq rows per (batch, head) row of
// the flattened (b h) axis, k and v skv rows per (batch, kv head); q row
// bh reads k/v row bh / group (grouped-query attention without a broadcast
// copy). Row i of q and key j sit at the global positions q_off + i and
// kv_off + j, which the causal mask compares: a flash launch has both
// offsets 0 and sq = skv = L, a ring step the offsets of its query shard
// and of the K/V block it holds.
struct Geometry {
  int64_t sq, skv;        // query rows, keys
  int64_t q_off, kv_off;  // global positions of query row 0 and key 0
  int group;              // q rows per k/v row
  int d;                  // head dim, the row stride of every tensor
  int causal;
  int64_t window;         // > 0: keep keys less than window positions back
  float scale;
};

// (query, key) at global positions kept by the mask: when causal, key not
// after the query and (window > 0) less than window positions before it
__device__ __forceinline__ bool keep(int64_t qpos, int64_t kpos, int causal,
                                     int64_t window) {
  if (!causal) return true;
  return qpos >= kpos && (window <= 0 || qpos - kpos < window);
}

// every (query, key) of the q tile of BQ rows at local row q0 and the kv
// tile of BK keys at local key k0 inside the tensors and kept by the mask,
// so that no pair needs a test: all but the diagonal and window-edge tiles
// of a causal sequence, and every whole tile of a non-causal one
template <int BQ, int BK>
__device__ __forceinline__ bool tile_unmasked(const Geometry& g, int64_t q0,
                                              int64_t k0) {
  if (q0 + BQ > g.sq || k0 + BK > g.skv) return false;
  if (!g.causal) return true;
  const int64_t qs = g.q_off + q0, ks = g.kv_off + k0;
  return ks + BK - 1 <= qs && (g.window <= 0 || qs + BQ - 1 - ks < g.window);
}

// (query row, key) of a tile kept: inside the tensors and by the mask
__device__ __forceinline__ bool pair_kept(const Geometry& g, int64_t qpos,
                                          int64_t kpos) {
  return qpos < g.sq && kpos < g.skv &&
         keep(g.q_off + qpos, g.kv_off + kpos, g.causal, g.window);
}

__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// kv tiles [begin, end) of BK keys (of skv, the first at global position
// kv_off) that the q tile of BQ rows at global position qs needs: none
// wholly after its last row, none wholly older than the window of its
// first row
template <int BQ, int BK>
__device__ __forceinline__ void kv_tiles_for_q(int64_t qs, int64_t kv_off,
                                               int64_t skv, int causal,
                                               int64_t window,
                                               int64_t* begin, int64_t* end) {
  const int64_t n_kv = (skv + BK - 1) / BK;
  *begin = 0;
  *end = n_kv;
  if (causal) {
    const int64_t last = floor_div(qs + BQ - 1 - kv_off, BK);
    *end = last + 1 < n_kv ? last + 1 : n_kv;
    if (window > 0) {
      const int64_t lo = qs - window - BK + 2 - kv_off;  // first start kept
      *begin = lo <= 0 ? 0 : (lo + BK - 1) / BK;
    }
  }
}

// q tiles [begin, end) of BQ rows (of sq, the first at global position
// q_off) that the kv tile of BK keys at global position ks feeds: from the
// tile holding its first key's diagonal to the last whose first row is
// within the window of its last key (the same rule read the other way)
template <int BQ, int BK>
__device__ __forceinline__ void q_tiles_for_kv(int64_t ks, int64_t q_off,
                                               int64_t sq, int causal,
                                               int64_t window,
                                               int64_t* begin, int64_t* end) {
  const int64_t n_q = (sq + BQ - 1) / BQ;
  *begin = 0;
  *end = n_q;
  if (causal) {
    const int64_t first = floor_div(ks - q_off, BQ);
    *begin = first > 0 ? first : 0;
    if (window > 0) {
      const int64_t last = floor_div(ks - q_off + BK - 2 + window, BQ) + 1;
      *end = last < n_q ? last : n_q;
    }
  }
}

// the compiled width a head dim runs in (256, in slices, above 256), 0 for
// none
inline int compiled_width(int d) {
  if (d <= 0) return 0;
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// slices of kSliceWidth output columns a head dim runs in
__host__ __device__ __forceinline__ int n_slices(int d) {
  return (d + kSliceWidth - 1) / kSliceWidth;
}

// checks shared by the entry points; 0 if the launch may go ahead
inline cudaError_t check_geometry(long long rows, const Geometry& g) {
  if (g.group <= 0 || rows % g.group != 0 || g.window < 0 ||
      (g.window > 0 && !g.causal) || compiled_width(g.d) == 0)
    return cudaErrorInvalidValue;
  const int64_t longest = g.sq > g.skv ? g.sq : g.skv;
  if (rows > 0x7fffffffLL || (longest + kMinTile - 1) / kMinTile > 65535)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// Calls launcher.template go<D, kExact, kWide>() for the compiled width of
// d: kExact when d is that width (compile-time strides, no column checks),
// kWide when d is above 256 (slices and chunks).
template <class Launcher>
cudaError_t dispatch_width(int d, const Launcher& f) {
  switch (compiled_width(d)) {
    case 16:
      return d == 16 ? f.template go<16, true, false>()
                     : f.template go<16, false, false>();
    case 32:
      return d == 32 ? f.template go<32, true, false>()
                     : f.template go<32, false, false>();
    case 64:
      return d == 64 ? f.template go<64, true, false>()
                     : f.template go<64, false, false>();
    case 128:
      return d == 128 ? f.template go<128, true, false>()
                      : f.template go<128, false, false>();
    case 256:
      return d == 256  ? f.template go<256, true, false>()
             : d < 256 ? f.template go<256, false, false>()
                       : f.template go<256, false, true>();
    default:
      return cudaErrorInvalidValue;
  }
}

// above 48 KB a block's dynamic shared memory must be allowed first
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace flash
