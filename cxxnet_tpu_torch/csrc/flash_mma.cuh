// Tensor-core and asynchronous-copy pieces of the flash kernels (the
// forward body flash_fwd_tc.cuh, the backward bodies flash_bwd_dq_tc.cuh
// and flash_bwd_dkv_tc.cuh), for sm_90a: the 3xTF32 split, the m16n8k8
// TF32 product, ldmatrix fragment loads and the cp.async tile copy with
// zero fill.
//
// m16n8k8 TF32 fragments (PTX ISA, mma.m16n8k8 .tf32), lane l, grp = l / 4,
// t = l % 4:
//   A (16 x 8, row-major)  a0 (grp, t)   a1 (grp + 8, t)
//                          a2 (grp, t+4) a3 (grp + 8, t + 4)
//   B (8 x 8, k x n)       b0 (k t, n grp)   b1 (k t + 4, n grp)
//   C (16 x 8)             c0 (grp, 2t)  c1 (grp, 2t + 1)
//                          c2 (grp + 8, 2t)  c3 (grp + 8, 2t + 1)
// A product's sum over k does not depend on the order of k, so a k-step
// may read its 8 k indices in any order that A and B share. Two uses:
//  - the C fragment of one product is the A fragment of the next with the
//    k order (2t, 2t + 1) in place of (t, t + 4): a = {c0, c2, c1, c3},
//    B then read at the rows 2t and 2t + 1 of the k-step, so P and dS
//    never leave registers (mma_p_x);
//  - a bf16 tile read with ldmatrix gives each lane the pair (2t, 2t + 1)
//    of its row in one register: the same k order again.
//
// 3xTF32 (CUTLASS's OpMultiplyAddFastF32): an fp32 operand x is split in
// registers into big = rna(x), a TF32 value, and small = x - big, and a
// product is small*big + big*small + big*big: the lost small*small term
// and the truncation of small are within 2^-21 of |x y|, where one TF32
// product keeps 2^-11. A bf16 value is exact in TF32 and needs no split: a
// product of two bf16 operands is one TF32 product, of a bf16 and a split
// f32 operand two.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

// x rounded to TF32, to nearest with ties away from zero: bit for bit
// cvt.rna.tf32.f32 on every finite x (and on infinities), in two integer
// operations where ptxas expands cvt.rna into several: half a TF32 ulp
// (bit 12) added to the magnitude carries into the kept bits exactly when
// the dropped 13 bits are at least half an ulp, and the mask drops them
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small: big = rna(x) exactly TF32, small = x - big exact in f32
// (|small| <= 2^-11 |x|) and left as it is: the mma reads a TF32 operand's
// top 19 bits, so it rounds small toward zero, within 2^-21 |x|, beside
// the dropped small * small term (2^-22 |x y|). Rounding small with
// cvt.rna too (2^-22) cost two more instructions an element, in kernels
// bound by the issue of instructions, for nothing visible against the
// 1e-5 bar
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a b, one m16n8k8 TF32 product with an f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment as TF32 words: big, and small when kSplit (an fp32 operand)
template <bool kSplit>
struct FragA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(int i, float x) {
    if constexpr (kSplit)
      split_tf32(x, big[i], small[i]);
    else
      big[i] = __float_as_uint(x);
  }
};

template <bool kSplit>
struct FragB {
  uint32_t big[2], small[2];
  __device__ __forceinline__ void set(int i, float x) {
    if constexpr (kSplit)
      split_tf32(x, big[i], small[i]);
    else
      big[i] = __float_as_uint(x);
  }
};

// c += a b in as many TF32 products as the operands' splits need (3, 2 or
// 1), the small terms first. The tensor cores round their sum toward zero,
// so a long sum fed back as the mma's C drifts toward zero by up to an ulp
// a product (768 products for a dK row at L 2,048: beyond the 1e-5 bar on
// the card). Where an operand is split (fp32 inputs) the products go into
// a fresh zero accumulator and reach c by one rounded f32 addition; a
// product of two bf16 operands goes straight into c, far inside bf16's
// bar.
template <bool kSa, bool kSb>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const FragA<kSa>& a,
                                           const FragB<kSb>& b) {
  if constexpr (!kSa && !kSb) {
    mma_tf32(c, a.big, b.big);
  } else {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (kSa) mma_tf32(t, a.small, b.big);
    if constexpr (kSb) mma_tf32(t, a.big, b.small);
    mma_tf32(t, a.big, b.big);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += t[i];
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8,
// row l % 8, and receives in r[i] the b16 pair (l / 4, 2 (l % 4) ..+1) of
// matrix i: of an fp32 tile, the element (l / 4, l % 4) of an 8 x 4 block
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the two bf16 of a ldmatrix register as floats (exact), column 2t first
__device__ __forceinline__ float bf16_lo(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t r) {
  return __uint_as_float(r & 0xffff0000u);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n of this thread's copy groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// 16-byte copy, zero-filled when !in (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

// 4-byte copy, zero-filled when !in
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

// How a launch copies its rows: kVec16 in 16-byte copies (every pointer
// 16-byte aligned and a row a multiple of 16 bytes), kVec4 in 4-byte
// copies (4-byte alignment), else element by element with plain loads and
// stores (a bf16 tensor of odd head dim)
enum CopyMode { kVec16 = 16, kVec4 = 4, kScalar = 0 };

inline int copy_mode(const void* const* ptrs, int n, int d, int esize) {
  bool a16 = (int64_t)d * esize % 16 == 0, a4 = (int64_t)d * esize % 4 == 0;
  for (int i = 0; i < n; ++i) {
    const uintptr_t p = reinterpret_cast<uintptr_t>(ptrs[i]);
    a16 = a16 && p % 16 == 0;
    a4 = a4 && p % 4 == 0;
  }
  return a16 ? kVec16 : a4 ? kVec4 : kScalar;
}

// Starts the copy of rows [row0, row0 + ROWS) and columns [c0, c0 + W) of
// a (rows, d) matrix of T (row stride d) into the shared tile dst[ROWS][S]
// of T; rows past `rows` and columns past d land as zeros, so a product
// over them adds exact zeros. The copies join the thread's open cp.async
// group; in kScalar mode they are plain stores, visible after the next
// barrier like the rest.
template <int ROWS, int W, int S, int kThreads, typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int64_t row0,
                                          int64_t rows, int c0, int d,
                                          int mode, int tid) {
  if (mode == kVec16) {
    constexpr int E = 16 / sizeof(T), CPR = W / E;
    for (int i = tid; i < ROWS * CPR; i += kThreads) {
      const int r = i / CPR, c = i % CPR * E;
      const int64_t gr = row0 + r;
      const bool in = gr < rows && c0 + c < d;
      cp_async16(dst + r * S + c, in ? src + gr * d + c0 + c : src, in);
    }
  } else if (mode == kVec4) {
    constexpr int E = 4 / sizeof(T), CPR = W / E;
    for (int i = tid; i < ROWS * CPR; i += kThreads) {
      const int r = i / CPR, c = i % CPR * E;
      const int64_t gr = row0 + r;
      const bool in = gr < rows && c0 + c < d;
      cp_async4(dst + r * S + c, in ? src + gr * d + c0 + c : src, in);
    }
  } else {
    for (int i = tid; i < ROWS * W; i += kThreads) {
      const int r = i / W, c = i % W;
      const int64_t gr = row0 + r;
      dst[r * S + c] = (gr < rows && c0 + c < d) ? src[gr * d + c0 + c]
                                                 : T(0.f);
    }
  }
}

// Starts the copy of n f32 values src[i0 .. i0 + n) (0 past `len`) into
// dst, 4 bytes a copy
template <int N, int kThreads>
__device__ __forceinline__ void copy_row_f32(float* dst, const float* src,
                                             int64_t i0, int64_t len,
                                             int tid) {
  for (int i = tid; i < N; i += kThreads) {
    const bool in = i0 + i < len;
    cp_async4(dst + i, in ? src + i0 + i : src, in);
  }
}

// the element (r, c) of a shared tile as f32
__device__ __forceinline__ float smem_f32(const float* p) { return *p; }
__device__ __forceinline__ float smem_f32(const __nv_bfloat16* p) {
  return __uint_as_float((uint32_t)(*reinterpret_cast<const uint16_t*>(p))
                         << 16);
}

// acc[n] += A B_n^T over W columns: A the warp's 16 rows at a, B_n the 8
// rows at b + 8 n S, both row-major tiles of T with row stride S. The
// score-like products: S = Q K^T and dP = dO V^T in dQ, S^T = K Q^T and
// dP^T = V dO^T in dK/dV. fp32 tiles read each fragment with one
// ldmatrix and run 3xTF32; bf16 tiles read two k-steps a ldmatrix in the
// k order (2t, 2t + 1) and run one TF32 product (both operands exact).
// Over at most 64 columns (24 products) the fp32 products go straight
// into acc: their drift toward zero stays within 24 ulps of the score
// (3e-6 of it), which spares the four additions a fresh accumulator costs
// per group; wider sums (the 256-column chunks) take the fresh
// accumulator of mma_3xtf32.
template <int NT, int W, int S, typename T>
__device__ __forceinline__ void mma_rows_t(float (&acc)[NT][4], const T* a,
                                           const T* b, int lane) {
  static_assert(NT % 2 == 0 && W % 16 == 0, "tile shape");
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int l8 = lane % 8, l8h = (lane / 8) % 2, l16 = lane / 16;
  if constexpr (kF32) {
    const T* pa = a + (l8 + 8 * l8h) * S + 4 * l16;
    const T* pb = b + (l8 + 8 * l16) * S + 4 * l8h;
#pragma unroll 1
    for (int k0 = 0; k0 < W; k0 += 8) {
      uint32_t r[4];
      FragA<true> fa;
      ldmatrix_x4(r, pa + k0);
#pragma unroll
      for (int i = 0; i < 4; ++i) fa.set(i, __uint_as_float(r[i]));
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        ldmatrix_x4(r, pb + n * 8 * S + k0);
        FragB<true> f0, f1;
        f0.set(0, __uint_as_float(r[0]));
        f0.set(1, __uint_as_float(r[1]));
        f1.set(0, __uint_as_float(r[2]));
        f1.set(1, __uint_as_float(r[3]));
        if constexpr (W <= 64) {
          mma_tf32(acc[n], fa.small, f0.big);
          mma_tf32(acc[n], fa.big, f0.small);
          mma_tf32(acc[n], fa.big, f0.big);
          mma_tf32(acc[n + 1], fa.small, f1.big);
          mma_tf32(acc[n + 1], fa.big, f1.small);
          mma_tf32(acc[n + 1], fa.big, f1.big);
        } else {
          mma_3xtf32(acc[n], fa, f0);
          mma_3xtf32(acc[n + 1], fa, f1);
        }
      }
    }
  } else {
    const T* pa = a + (l8 + 8 * l8h) * S + 8 * l16;
    const T* pb = b + (l8 + 8 * l16) * S + 8 * l8h;
#pragma unroll 1
    for (int k0 = 0; k0 < W; k0 += 16) {
      uint32_t r[4];
      FragA<false> fa0, fa1;
      ldmatrix_x4(r, pa + k0);
      fa0.set(0, bf16_lo(r[0]));
      fa0.set(1, bf16_lo(r[1]));
      fa0.set(2, bf16_hi(r[0]));
      fa0.set(3, bf16_hi(r[1]));
      fa1.set(0, bf16_lo(r[2]));
      fa1.set(1, bf16_lo(r[3]));
      fa1.set(2, bf16_hi(r[2]));
      fa1.set(3, bf16_hi(r[3]));
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        ldmatrix_x4(r, pb + n * 8 * S + k0);
        FragB<false> f;
        f.set(0, bf16_lo(r[0]));
        f.set(1, bf16_hi(r[0]));
        mma_3xtf32(acc[n], fa0, f);
        f.set(0, bf16_lo(r[1]));
        f.set(1, bf16_hi(r[1]));
        mma_3xtf32(acc[n], fa1, f);
        f.set(0, bf16_lo(r[2]));
        f.set(1, bf16_hi(r[2]));
        mma_3xtf32(acc[n + 1], fa0, f);
        f.set(0, bf16_lo(r[3]));
        f.set(1, bf16_hi(r[3]));
        mma_3xtf32(acc[n + 1], fa1, f);
      }
    }
  }
}

// acc[n] += P X_n over KT k-steps: P (16 x 8 KT) the C fragments pc of the
// product before (P, dS, P^T or dS^T, f32, split in registers), X the
// shared tile at x (row stride S, its 8 KT rows the k index), X_n its 8
// columns at 8 n. The k-step j reads P's columns in the order of its C
// fragment, (2t, 2t + 1), so X's rows 8 j + 2t and 8 j + 2t + 1. Two
// k-steps (6 products in fp32, 4 in bf16) go into a fresh accumulator and
// reach acc by one rounded addition: acc sums over the whole sequence, so
// the mma's rounding toward zero must not touch it (mma_3xtf32), and
// pairing the k-steps halves those additions.
template <int KT, int NO, int S, typename T>
__device__ __forceinline__ void mma_p_x(float (&acc)[NO][4],
                                        const float (&pc)[KT][4], const T* x,
                                        int lane) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  const T* px = x + 2 * (lane % 4) * S + lane / 4;
  static_assert(KT % 2 == 0, "k-steps in pairs");
#pragma unroll
  for (int j = 0; j < KT; j += 2) {
    FragA<true> fa, fa2;
    fa.set(0, pc[j][0]);
    fa.set(1, pc[j][2]);
    fa.set(2, pc[j][1]);
    fa.set(3, pc[j][3]);
    fa2.set(0, pc[j + 1][0]);
    fa2.set(1, pc[j + 1][2]);
    fa2.set(2, pc[j + 1][1]);
    fa2.set(3, pc[j + 1][3]);
    const T* pj = px + 8 * j * S;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      FragB<kF32> fb, fb2;
      fb.set(0, smem_f32(pj + 8 * n));
      fb.set(1, smem_f32(pj + S + 8 * n));
      fb2.set(0, smem_f32(pj + 8 * S + 8 * n));
      fb2.set(1, smem_f32(pj + 9 * S + 8 * n));
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(t, fa.small, fb.big);
      if constexpr (kF32) mma_tf32(t, fa.big, fb.small);
      mma_tf32(t, fa.big, fb.big);
      mma_tf32(t, fa2.small, fb2.big);
      if constexpr (kF32) mma_tf32(t, fa2.big, fb2.small);
      mma_tf32(t, fa2.big, fb2.big);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += t[i];
    }
  }
}

}  // namespace flash
