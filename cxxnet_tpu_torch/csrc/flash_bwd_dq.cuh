// The dQ kernel body shared by flash_bwd_dq.cu (the flash backward's dQ)
// and ring_dq_step.cu (one ring step's dQ contribution): one block owns 64
// query rows of one (batch, head) row and one slice of the head dim, and
// accumulates dQ += scale (P o (dP - D)) K in registers over the kv tiles
// the mask keeps. Where the accumulator starts and where it goes is the IO
// policy's: the flash dQ starts from 0 and stores in the input dtype; a
// ring step reads the f32 carry and writes it back. flash_bwd_dq.cu's
// header states the layout and the bound, ring_dq_step.cu's what the ring
// changes.
//
// The IO policy provides, for a query row `row` of the flattened (b h sq)
// axis and the thread's dQ columns col[]:
//   init(row, col, d, acc)   the accumulator the row starts from
//   store(row, col, d, acc)  the row's result

#pragma once

#include "flash_common.cuh"

namespace flash {

template <int D>
struct DqTiles {
  static constexpr int TX = D >= 128 ? 32 : 16;  // column lanes
  static constexpr int BK = D == 256 ? 32 : kBK; // keys per tile
  static constexpr int kPadKT = BK + 1;          // row stride of K^T, V^T
  static constexpr int kThreads = 8 * TX;        // 8 row groups
  static constexpr int kRows = 8;                // query rows per thread
  static constexpr int NC = BK / TX;             // score columns per thread
  static constexpr int NA = D / TX;              // dQ columns per thread
  // Q^T, dO^T [D][kPadQ]; K^T, V^T [D][kPadKT]; dS^T [BK][kPadQ]
  static constexpr size_t smem =
      sizeof(float) * (size_t)(2 * D * kPadQ + 2 * D * kPadKT + BK * kPadQ);
};

// dS = P (dP - D) scale of the thread's 8 x NC block, written transposed
// (dst[key][query row]), with P = exp(S scale - lse). kMasked: test every
// pair (a diagonal, window-edge or ragged tile); a masked pair gets p = 0
// outright
template <bool kMasked, int TX, int kRows, int NC>
__device__ __forceinline__ void ds_tile(const float (&s)[kRows][NC],
                                        const float (&dp)[kRows][NC],
                                        const float (&lse_r)[kRows],
                                        const float (&d_r)[kRows],
                                        float* dst, const Geometry& g,
                                        int64_t row0, int64_t key0, int r0,
                                        int c0) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      const float p = (!kMasked || pair_kept(g, row0 + i, key0 + TX * jj))
                          ? expf(s[i][jj] * g.scale - lse_r[i])
                          : 0.f;
      dst[(c0 + TX * jj) * kPadQ + r0 + i] =
          p * (dp[i][jj] - d_r[i]) * g.scale;
    }
  }
}

template <typename T, int D, bool kExact, bool kWide, class IO>
__global__ void __launch_bounds__(DqTiles<D>::kThreads)
attn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const Geometry g, const IO io) {
  // the row stride; the compiled width itself when d is one of them
  const int d = kExact ? D : g.d;
  using C = DqTiles<D>;
  constexpr int TX = C::TX, kRows = C::kRows, NC = C::NC, NA = C::NA;
  constexpr int BK = C::BK, kPadKT = C::kPadKT;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* dot = qt + D * kPadQ;
  float* kt = dot + D * kPadQ;
  float* vt = kt + D * kPadKT;
  float* dst = vt + D * kPadKT;

  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const int64_t bh = blockIdx.x;
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * kBQ;
  // the slice of the head dim whose dQ this block owns; the chunks of the
  // S / dP pass, its own last so that K^T holds it for the dQ product
  const int slice = kWide ? (int)blockIdx.z : 0;
  const int col0 = slice * D;
  const int n_chunks = kWide ? n_slices(d) : 1;
  const T* qp = q + bh * g.sq * d;
  const T* dop = dout + bh * g.sq * d;
  const T* kp = k + bh / g.group * g.skv * d;
  const T* vp = v + bh / g.group * g.skv * d;

  if (!kWide) {
    for (int idx = tid; idx < kBQ * D; idx += C::kThreads) {
      const int r = idx / D, c = idx % D;
      qt[c * kPadQ + r] = load_or_zero<kExact>(qp, q0 + r, g.sq, c, d);
      dot[c * kPadQ + r] = load_or_zero<kExact>(dop, q0 + r, g.sq, c, d);
    }
  }
  int col[NA];
#pragma unroll
  for (int c = 0; c < NA; ++c) col[c] = col0 + tx + TX * c;
  // lse and D of the thread's rows; rows past sq take 0 and are not stored
  float lse_r[kRows], d_r[kRows], acc[kRows][NA];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t qpos = q0 + ty * 8 + i;
    lse_r[i] = qpos < g.sq ? lse[bh * g.sq + qpos] : 0.f;
    d_r[i] = qpos < g.sq ? delta[bh * g.sq + qpos] : 0.f;
    if (qpos < g.sq) {
      io.init(bh * g.sq + qpos, col, d, acc[i]);
    } else {
#pragma unroll
      for (int c = 0; c < NA; ++c) acc[i][c] = 0.f;
    }
  }

  int64_t kv_begin, kv_end;
  kv_tiles_for_q<kBQ, BK>(g.q_off + q0, g.kv_off, g.skv, g.causal, g.window,
                          &kv_begin, &kv_end);

  for (int64_t j = kv_begin; j < kv_end; ++j) {
    const int64_t k0 = j * BK;
    // S = Q K^T and dP = dO V^T for the thread's 8 x NC block
    float s[kRows][NC], dp[kRows][NC];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) s[i][jj] = dp[i][jj] = 0.f;
    for (int ch = 1; ch <= n_chunks; ++ch) {
      const int cc = kWide ? (slice + ch) % n_chunks * D : 0;
      __syncthreads();  // the last chunk's and tile's readers are done
      if (kWide) {
        for (int idx = tid; idx < kBQ * D; idx += C::kThreads) {
          const int r = idx / D, c = idx % D;
          qt[c * kPadQ + r] = load_or_zero<false>(qp, q0 + r, g.sq, cc + c, d);
          dot[c * kPadQ + r] =
              load_or_zero<false>(dop, q0 + r, g.sq, cc + c, d);
        }
      }
      for (int idx = tid; idx < BK * D; idx += C::kThreads) {
        const int r = idx / D, c = idx % D;
        kt[c * kPadKT + r] =
            load_or_zero<kExact>(kp, k0 + r, g.skv, cc + c, d);
        vt[c * kPadKT + r] =
            load_or_zero<kExact>(vp, k0 + r, g.skv, cc + c, d);
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        const float4 qa =
            *reinterpret_cast<const float4*>(qt + c * kPadQ + ty * 8);
        const float4 qb =
            *reinterpret_cast<const float4*>(qt + c * kPadQ + ty * 8 + 4);
        const float4 da =
            *reinterpret_cast<const float4*>(dot + c * kPadQ + ty * 8);
        const float4 db =
            *reinterpret_cast<const float4*>(dot + c * kPadQ + ty * 8 + 4);
        const float qv[kRows] = {qa.x, qa.y, qa.z, qa.w,
                                 qb.x, qb.y, qb.z, qb.w};
        const float dv[kRows] = {da.x, da.y, da.z, da.w,
                                 db.x, db.y, db.z, db.w};
        float kv[NC], vv[NC];
#pragma unroll
        for (int jj = 0; jj < NC; ++jj) {
          kv[jj] = kt[c * kPadKT + tx + TX * jj];
          vv[jj] = vt[c * kPadKT + tx + TX * jj];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int jj = 0; jj < NC; ++jj) {
            s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
            dp[i][jj] = fmaf(dv[i], vv[jj], dp[i][jj]);
          }
      }
    }

    if (tile_unmasked<kBQ, BK>(g, q0, k0))
      ds_tile<false, TX>(s, dp, lse_r, d_r, dst, g, q0 + ty * 8, k0 + tx,
                         ty * 8, tx);
    else
      ds_tile<true, TX>(s, dp, lse_r, d_r, dst, g, q0 + ty * 8, k0 + tx,
                        ty * 8, tx);
    __syncthreads();

    // dQ += dS K, K^T holding the block's own slice
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 sa =
          *reinterpret_cast<const float4*>(dst + kk * kPadQ + ty * 8);
      const float4 sb =
          *reinterpret_cast<const float4*>(dst + kk * kPadQ + ty * 8 + 4);
      const float sv[kRows] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
      float kv[NA];
#pragma unroll
      for (int c = 0; c < NA; ++c) kv[c] = kt[(tx + TX * c) * kPadKT + kk];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < NA; ++c) acc[i][c] = fmaf(sv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t qpos = q0 + ty * 8 + i;
    if (qpos < g.sq) io.store(bh * g.sq + qpos, col, d, acc[i]);
  }
}

// launches attn_dq_kernel over q (rows, sq, d) for the compiled width of
// g.d: grid (rows, q tiles, slices)
template <typename T, class IO>
struct DqLauncher {
  const T *q, *k, *v, *dout;
  const float *lse, *delta;
  long long rows;
  Geometry g;
  IO io;
  cudaStream_t stream;

  template <int D, bool kExact, bool kWide>
  cudaError_t go() const {
    using C = DqTiles<D>;
    const auto kernel = attn_dq_kernel<T, D, kExact, kWide, IO>;
    const cudaError_t err = allow_smem(kernel, C::smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)rows, (unsigned)((g.sq + kBQ - 1) / kBQ),
                    (unsigned)n_slices(g.d));
    kernel<<<grid, C::kThreads, C::smem, stream>>>(q, k, v, dout, lse, delta,
                                                   g, io);
    return cudaGetLastError();
  }
};

template <typename T, class IO>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      long long rows, const Geometry& g, const IO& io,
                      cudaStream_t stream) {
  const DqLauncher<T, IO> f{
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      rows, g, io, stream};
  return dispatch_width(g.d, f);
}

}  // namespace flash
