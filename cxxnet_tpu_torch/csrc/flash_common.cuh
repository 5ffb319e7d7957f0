// Shared pieces of the flash attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): tile sizes, the finite NEG_INF, the
// fp32/bf16 load and store, the tile ranges that _block_needed keeps
// (cxxnet_tpu/ops/flash_attn.py:66-79), and the compiled head width.
//
// Head dims. The kernels are compiled for the widths 16, 32, 64, 128 and
// 256; a head dim d <= 256 runs in the smallest width W >= d. Loads
// zero-fill the columns d .. W-1 and stores skip them, so every dot product
// over the head dim gains only zero terms and the result is exact. Tensors
// keep their own row stride d. Width 256 takes a layout of its own in each
// kernel (more column lanes, and in the backward a 32-key tile), so that
// its accumulators stay in registers and its tiles within the 227 KB of
// shared memory a block may opt into.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

constexpr int kBQ = 64;          // query rows per tile
constexpr int kBK = 64;          // keys per tile (32 in the backward at 256)
constexpr int kMinTile = 32;     // the smallest tile any kernel's grid walks
constexpr int kPadQ = kBQ + 4;   // row stride of a transposed 64-row tile
constexpr int kPadK = kBK + 1;   // row stride of a transposed 64-key tile
constexpr float kNegInf = -1e30f;
constexpr int kMaxHeadDim = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// element (row, c) of a (rows, d) matrix, 0 past the row count or the
// head dim (the zero-filled columns of the compiled width); kExact: d is
// the compiled width, so every column is inside
template <bool kExact, typename T>
__device__ __forceinline__ float load_or_zero(const T* base, int64_t row,
                                              int64_t rows, int c, int d) {
  return (row < rows && (kExact || c < d)) ? to_f32(base[row * d + c]) : 0.f;
}

// (query, key) kept by the mask: key inside the sequence and, when causal,
// not after the query and (window > 0) less than window positions before
__device__ __forceinline__ bool keep(int64_t qpos, int64_t kpos, int64_t L,
                                     int causal, int64_t window) {
  bool k = kpos < L;
  if (causal) {
    k = k && qpos >= kpos;
    if (window > 0) k = k && (qpos - kpos < window);
  }
  return k;
}

// kv tiles [begin, end) of BK keys that the q tile of BQ rows starting at
// q0 needs: none above the causal diagonal, none wholly older than the
// window of its oldest query
template <int BQ, int BK>
__device__ __forceinline__ void kv_tiles_for_q(int64_t q0, int64_t L,
                                               int causal, int64_t window,
                                               int64_t* begin, int64_t* end) {
  const int64_t n_kv = (L + BK - 1) / BK;
  *begin = 0;
  *end = n_kv;
  if (causal) {
    const int64_t diag = (q0 + BQ - 1) / BK + 1;
    *end = diag < n_kv ? diag : n_kv;
    if (window > 0) {
      const int64_t lo = q0 - window - BK + 2;  // first tile start kept
      *begin = lo <= 0 ? 0 : (lo + BK - 1) / BK;
    }
  }
}

// q tiles [begin, end) of BQ rows that the kv tile of BK keys starting at
// k0 feeds: from the tile holding the diagonal down to the last query
// within the window of the tile's newest key (the same _block_needed, read
// the other way)
template <int BQ, int BK>
__device__ __forceinline__ void q_tiles_for_kv(int64_t k0, int64_t L,
                                               int causal, int64_t window,
                                               int64_t* begin, int64_t* end) {
  const int64_t n_q = (L + BQ - 1) / BQ;
  *begin = 0;
  *end = n_q;
  if (causal) {
    *begin = k0 / BQ;
    if (window > 0) {
      const int64_t last = (k0 + BK - 2 + window) / BQ + 1;
      *end = last < n_q ? last : n_q;
    }
  }
}

// the compiled width a head dim runs in, 0 if none takes it
inline int compiled_width(int d) {
  if (d <= 0 || d > kMaxHeadDim) return 0;
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// checks shared by the entry points; 0 if the launch may go ahead
inline cudaError_t check_args(long long batch, int heads, int kv_heads,
                              long long L, int d, int causal,
                              long long window) {
  if (heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || window < 0 ||
      (window > 0 && !causal) || compiled_width(d) == 0)
    return cudaErrorInvalidValue;
  if (batch * heads > 0x7fffffffLL || (L + kMinTile - 1) / kMinTile > 65535)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

}  // namespace flash
