// The forward kernel body shared by flash_fwd.cu (the flash forward) and
// ring_fwd_step.cu (one ring step's online-softmax update): one block owns
// 64 query rows of one (batch, head) row and one slice of the head dim,
// and carries the online softmax (m, l, acc) in registers over the kv
// tiles the mask keeps. Where the carry starts and where it goes is the IO
// policy's: the flash forward starts from (NEG_INF, 0, 0) and writes
// out = acc / l and lse; a ring step reads the carry of the previous step
// and writes it back. flash_fwd.cu's header states the layout and the
// bound, ring_fwd_step.cu's what the ring changes.
//
// The IO policy provides, for a query row `row` of the flattened
// (b h sq) axis and the thread's accumulator columns col[]:
//   init(row, col, d, m, l, acc)          the carry the row starts from
//   store(row, col, d, stats, m, l, acc)  the row's result; `stats` is
//                                         true for the one thread that
//                                         writes the row's statistics

#pragma once

#include "flash_common.cuh"

namespace flash {

template <int D>
struct FwdTiles {
  static constexpr int TX = D == 256 ? 32 : 16;  // column lanes
  static constexpr int kThreads = 8 * TX;        // 8 row groups
  static constexpr int kRows = 8;                // query rows per thread
  static constexpr int NC = kBK / TX;            // score columns per thread
  static constexpr int NA = D / TX;              // accumulator columns
  // Q^T [D][kPadQ], K^T [D][kPadK], V [kBK][D], P^T [kBK][kPadQ]
  static constexpr size_t smem =
      sizeof(float) * (size_t)(D * kPadQ + D * kPadK + kBK * D + kBK * kPadQ);
};

// One kv tile folded into the thread's rows of the online softmax: S
// scaled, the row max and sum reduced over the TX lanes, the carry
// rescaled, S replaced by P. kMasked: test every pair (a tile on the
// diagonal, the window's edge or a ragged edge); a masked score is NEG_INF
// and its mass is set to 0 outright (_fwd_step_kernel,
// cxxnet_tpu/ops/ring_flash.py:111-114), so a row whose keys in the tile
// are all masked keeps its carry unchanged
template <bool kMasked, int TX, int kRows, int NC, int NA>
__device__ __forceinline__ void fold_tile(float (&s)[kRows][NC],
                                          float (&m)[kRows],
                                          float (&l)[kRows],
                                          float (&acc)[kRows][NA],
                                          const Geometry& g, int64_t row0,
                                          int64_t key0) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float rmax = kNegInf;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      s[i][jj] = (!kMasked || pair_kept(g, row0 + i, key0 + TX * jj))
                     ? s[i][jj] * g.scale
                     : kNegInf;
      rmax = fmaxf(rmax, s[i][jj]);
    }
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
    const float m_new = fmaxf(m[i], rmax);
    const float alpha = expf(m[i] - m_new);
    float rsum = 0.f;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      s[i][jj] = kMasked && s[i][jj] <= 0.5f * kNegInf
                     ? 0.f
                     : expf(s[i][jj] - m_new);
      rsum += s[i][jj];
    }
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
    l[i] = l[i] * alpha + rsum;
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < NA; ++c) acc[i][c] *= alpha;
  }
}

template <typename T, int D, bool kExact, bool kWide, class IO>
__global__ void __launch_bounds__(FwdTiles<D>::kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const Geometry g, const IO io) {
  // the row stride; the compiled width itself when d is one of them
  const int d = kExact ? D : g.d;
  using C = FwdTiles<D>;
  constexpr int TX = C::TX, kRows = C::kRows, NC = C::NC, NA = C::NA;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* kt = qt + D * kPadQ;
  float* vs = kt + D * kPadK;
  float* pt = vs + kBK * D;

  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const int64_t bh = blockIdx.x;
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * kBQ;
  // the slice of the head dim whose accumulator this block owns
  const int col0 = kWide ? (int)blockIdx.z * D : 0;
  // the head dim the score product runs over, in chunks of D columns
  const int d_span = kWide ? d : D;
  const T* qp = q + bh * g.sq * d;
  const T* kp = k + bh / g.group * g.skv * d;
  const T* vp = v + bh / g.group * g.skv * d;

  if (!kWide) {
    for (int idx = tid; idx < kBQ * D; idx += C::kThreads) {
      const int r = idx / D, c = idx % D;
      qt[c * kPadQ + r] = load_or_zero<kExact>(qp, q0 + r, g.sq, c, d);
    }
  }

  int col[NA];
#pragma unroll
  for (int c = 0; c < NA; ++c) col[c] = col0 + tx + TX * c;
  float m[kRows], l[kRows], acc[kRows][NA];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t qpos = q0 + ty * 8 + i;
    if (qpos < g.sq) {
      io.init(bh * g.sq + qpos, col, d, m[i], l[i], acc[i]);
    } else {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < NA; ++c) acc[i][c] = 0.f;
    }
  }

  // the kv tiles _tile_needed keeps
  int64_t kv_begin, kv_end;
  kv_tiles_for_q<kBQ, kBK>(g.q_off + q0, g.kv_off, g.skv, g.causal,
                           g.window, &kv_begin, &kv_end);

  for (int64_t j = kv_begin; j < kv_end; ++j) {
    const int64_t k0 = j * kBK;
    float s[kRows][NC];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) s[i][jj] = 0.f;
    for (int cc = 0; cc < d_span; cc += D) {
      __syncthreads();  // the last chunk's and tile's readers are done
      if (kWide) {
        for (int idx = tid; idx < kBQ * D; idx += C::kThreads) {
          const int r = idx / D, c = idx % D;
          qt[c * kPadQ + r] = load_or_zero<false>(qp, q0 + r, g.sq, cc + c, d);
        }
      }
      for (int idx = tid; idx < kBK * D; idx += C::kThreads) {
        const int r = idx / D, c = idx % D;
        kt[c * kPadK + r] = load_or_zero<kExact>(kp, k0 + r, g.skv, cc + c, d);
        if (cc == 0)
          vs[r * D + c] = load_or_zero<kExact>(vp, k0 + r, g.skv, col0 + c, d);
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        const float4 qa =
            *reinterpret_cast<const float4*>(qt + c * kPadQ + ty * 8);
        const float4 qb =
            *reinterpret_cast<const float4*>(qt + c * kPadQ + ty * 8 + 4);
        const float qv[kRows] = {qa.x, qa.y, qa.z, qa.w,
                                 qb.x, qb.y, qb.z, qb.w};
        float kv[NC];
#pragma unroll
        for (int jj = 0; jj < NC; ++jj) kv[jj] = kt[c * kPadK + tx + TX * jj];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int jj = 0; jj < NC; ++jj)
            s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
      }
    }

    if (tile_unmasked<kBQ, kBK>(g, q0, k0))
      fold_tile<false, TX>(s, m, l, acc, g, q0 + ty * 8, k0 + tx);
    else
      fold_tile<true, TX>(s, m, l, acc, g, q0 + ty * 8, k0 + tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int jj = 0; jj < NC; ++jj)
        pt[(tx + TX * jj) * kPadQ + ty * 8 + i] = s[i][jj];
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pa =
          *reinterpret_cast<const float4*>(pt + kk * kPadQ + ty * 8);
      const float4 pb =
          *reinterpret_cast<const float4*>(pt + kk * kPadQ + ty * 8 + 4);
      const float pv[kRows] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      float vv[NA];
#pragma unroll
      for (int c = 0; c < NA; ++c) vv[c] = vs[kk * D + tx + TX * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < NA; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t qpos = q0 + ty * 8 + i;
    if (qpos < g.sq)
      io.store(bh * g.sq + qpos, col, d, tx == 0 && col0 == 0, m[i], l[i],
               acc[i]);
  }
}

// launches attn_fwd_kernel over q (rows, sq, d) for the compiled width of
// g.d: grid (rows, q tiles, slices)
template <typename T, class IO>
struct FwdLauncher {
  const T *q, *k, *v;
  long long rows;
  Geometry g;
  IO io;
  cudaStream_t stream;

  template <int D, bool kExact, bool kWide>
  cudaError_t go() const {
    using C = FwdTiles<D>;
    const auto kernel = attn_fwd_kernel<T, D, kExact, kWide, IO>;
    const cudaError_t err = allow_smem(kernel, C::smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)rows, (unsigned)((g.sq + kBQ - 1) / kBQ),
                    (unsigned)n_slices(g.d));
    kernel<<<grid, C::kThreads, C::smem, stream>>>(q, k, v, g, io);
    return cudaGetLastError();
  }
};

template <typename T, class IO>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       long long rows, const Geometry& g, const IO& io,
                       cudaStream_t stream) {
  const FwdLauncher<T, IO> f{static_cast<const T*>(q),
                             static_cast<const T*>(k),
                             static_cast<const T*>(v), rows, g, io, stream};
  return dispatch_width(g.d, f);
}

}  // namespace flash
