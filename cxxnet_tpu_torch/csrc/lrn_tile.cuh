// Shared pieces of the LRN kernels (lrn_fwd.cu, lrn_bwd.cu): the tile a
// block owns, the 4-byte cp.async that stages a thread's column into shared
// memory, and the word-to-f32 reads of fp32 and bf16 elements. Each kernel's
// source comment states its design and bound.
//
// A channel row's stride (H*W elements) need not be a multiple of 4 bytes
// in bf16 or 16 bytes in either type, so a thread copies the aligned 4-byte
// word that holds its element and picks the element out of it; a word that
// holds a byte of the tensor lies in the tensor's allocation.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// channels a block owns; ops/lrn.py CHANNEL_TILE is the same number
constexpr int kChannelTile = 16;
// positions a block owns, one a thread
constexpr int kThreads = 128;
// shared memory a block may use on sm_90 (the opt-in maximum)
constexpr int kMaxSmem = 232448;

// one 4-byte cp.async, zero-filling the destination when src_bytes is 0
__device__ __forceinline__ void cp_async_word(uint32_t* smem, const void* src,
                                              int src_bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// the aligned 4-byte word that holds *p, and *p as f32 from that word
__device__ __forceinline__ const void* word_of(const float* p) { return p; }
__device__ __forceinline__ const void* word_of(const __nv_bfloat16* p) {
  return (const void*)((uintptr_t)p & ~(uintptr_t)3);
}
__device__ __forceinline__ float from_word(uint32_t w, const float*) {
  return __uint_as_float(w);
}
__device__ __forceinline__ float from_word(uint32_t w,
                                           const __nv_bfloat16* p) {
  return __uint_as_float(((uintptr_t)p & 2) ? (w & 0xffff0000u) : (w << 16));
}

__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

}  // namespace
