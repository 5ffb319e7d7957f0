// The dK/dV kernel body shared by flash_bwd_dkv.cu (the flash backward's
// dK and dV) and ring_dkv_step.cu (one ring step's dK/dV contribution):
// one block owns BK keys of one (batch, kv head) row and one slice of the
// head dim, loops over rows_per_block of the query rows that share the kv
// row (the flash dK/dV: the whole GQA group, summed in the block; a ring
// step: one query row, its carries at query-head resolution) and, for
// each, over
// the q tiles the mask keeps, and accumulates dV += P^T dO and
// dK += scale dS^T Q in registers. Where the accumulators
// start and where they go is the IO policy's: the flash dK/dV start from 0
// and are stored in the input dtype; a ring step reads the f32 carries
// that travel with the K/V block and writes them back.
// flash_bwd_dkv.cu's header states the layout and the bound,
// ring_dkv_step.cu's what the ring changes.
//
// The IO policy provides, for a key row `row` of the block's output rows
// ((b nkv skv), or (b h skv) at one query row a block) and the thread's
// columns col[]:
//   init(row, col, d, acc_k, acc_v)   the accumulators the row starts from
//   store(row, col, d, acc_k, acc_v)  the row's result

#pragma once

#include "flash_common.cuh"

namespace flash {

template <int D>
struct DkvTiles {
  static constexpr int BK = D == 256 ? 32 : kBK;  // keys per block
  static constexpr int TX = D == 256 ? 64 : D == 128 ? 32 : 16;  // lanes
  static constexpr int kRows = 8;                 // key rows per thread
  static constexpr int kThreads = BK / kRows * TX;  // BK / 8 row groups
  static constexpr int NC = kBQ / TX;             // query columns per thread
  static constexpr int NA = D / TX;               // dK, dV columns per thread
  static constexpr int kPadD = D + 1;             // row stride of Q and dO
  static constexpr int kPadKey = BK + 4;          // row stride of key rows
  // K^T, V^T [D][kPadKey]; Q, dO [kBQ][kPadD]; P^T, dS^T [kBQ][kPadKey];
  // lse, D [kBQ]
  static constexpr size_t smem =
      sizeof(float) * (size_t)(2 * D * kPadKey + 2 * kBQ * kPadD +
                               2 * kBQ * kPadKey + 2 * kBQ);
};

// P and dS = P (dP - D) scale of the thread's 8 keys x NC query rows,
// written transposed (pt, dst[query row][key]), with P = exp(S scale -
// lse). kMasked: test every pair (a diagonal, window-edge or ragged tile);
// a masked pair, a query row past sq or a key past skv gets p = 0
template <bool kMasked, int TX, int kPadKey, int kRows, int NC>
__device__ __forceinline__ void p_ds_tile(const float (&s)[kRows][NC],
                                          const float (&dp)[kRows][NC],
                                          const float* lse_s,
                                          const float* d_s, float* pt,
                                          float* dst, const Geometry& g,
                                          int64_t q0, int64_t key0, int r0,
                                          int tx) {
#pragma unroll
  for (int jj = 0; jj < NC; ++jj) {
    const int qc = tx + TX * jj;
    const float lse_q = lse_s[qc], d_q = d_s[qc];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float p = (!kMasked || pair_kept(g, q0 + qc, key0 + i))
                          ? expf(s[i][jj] * g.scale - lse_q)
                          : 0.f;
      pt[qc * kPadKey + r0 + i] = p;
      dst[qc * kPadKey + r0 + i] = p * (dp[i][jj] - d_q) * g.scale;
    }
  }
}

template <typename T, int D, bool kExact, bool kWide, class IO>
__global__ void __launch_bounds__(DkvTiles<D>::kThreads)
attn_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, const Geometry g,
                const int rows_per_block, const IO io) {
  // the row stride; the compiled width itself when d is one of them
  const int d = kExact ? D : g.d;
  using C = DkvTiles<D>;
  constexpr int TX = C::TX, kRows = C::kRows, NC = C::NC, NA = C::NA;
  constexpr int kPadD = C::kPadD, BK = C::BK, kPadKey = C::kPadKey;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;
  float* vt = kt + D * kPadKey;
  float* qs = vt + D * kPadKey;
  float* dos = qs + kBQ * kPadD;
  float* pt = dos + kBQ * kPadD;
  float* dst = pt + kBQ * kPadKey;
  float* lse_s = dst + kBQ * kPadKey;
  float* d_s = lse_s + kBQ;

  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  // the block's output row; its first query row and its k/v row
  const int64_t out_row = blockIdx.x;
  const int64_t row0 = out_row * rows_per_block;
  const int64_t bkv = row0 / g.group;
  const int64_t k0 = (int64_t)blockIdx.y * BK;
  // the slice of the head dim whose dK / dV this block owns; the chunks of
  // the S / dP pass, its own last so that Q and dO hold it for the product
  const int slice = kWide ? (int)blockIdx.z : 0;
  const int col0 = slice * D;
  const int n_chunks = kWide ? n_slices(d) : 1;
  const T* kp = k + bkv * g.skv * d;
  const T* vp = v + bkv * g.skv * d;

  if (!kWide) {
    for (int idx = tid; idx < BK * D; idx += C::kThreads) {
      const int r = idx / D, c = idx % D;
      kt[c * kPadKey + r] = load_or_zero<kExact>(kp, k0 + r, g.skv, c, d);
      vt[c * kPadKey + r] = load_or_zero<kExact>(vp, k0 + r, g.skv, c, d);
    }
  }
  int col[NA];
#pragma unroll
  for (int c = 0; c < NA; ++c) col[c] = col0 + tx + TX * c;
  float acc_k[kRows][NA], acc_v[kRows][NA];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t kpos = k0 + ty * 8 + i;
    if (kpos < g.skv) {
      io.init(out_row * g.skv + kpos, col, d, acc_k[i], acc_v[i]);
    } else {
#pragma unroll
      for (int c = 0; c < NA; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;
    }
  }

  int64_t q_begin, q_end;
  q_tiles_for_kv<kBQ, BK>(g.kv_off + k0, g.q_off, g.sq, g.causal, g.window,
                          &q_begin, &q_end);

  for (int gi = 0; gi < rows_per_block; ++gi) {
    const int64_t bh = row0 + gi;
    const T* qp = q + bh * g.sq * d;
    const T* dop = dout + bh * g.sq * d;
    for (int64_t t = q_begin; t < q_end; ++t) {
      const int64_t q0 = t * kBQ;
      // S^T = K Q^T and dP^T = V dO^T for the thread's 8 keys x NC queries
      float s[kRows][NC], dp[kRows][NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int jj = 0; jj < NC; ++jj) s[i][jj] = dp[i][jj] = 0.f;
      for (int ch = 1; ch <= n_chunks; ++ch) {
        const int cc = kWide ? (slice + ch) % n_chunks * D : 0;
        __syncthreads();  // the last chunk's and tile's readers are done
        if (kWide) {
          for (int idx = tid; idx < BK * D; idx += C::kThreads) {
            const int r = idx / D, c = idx % D;
            kt[c * kPadKey + r] =
                load_or_zero<false>(kp, k0 + r, g.skv, cc + c, d);
            vt[c * kPadKey + r] =
                load_or_zero<false>(vp, k0 + r, g.skv, cc + c, d);
          }
        }
        for (int idx = tid; idx < kBQ * D; idx += C::kThreads) {
          const int r = idx / D, c = idx % D;
          qs[r * kPadD + c] =
              load_or_zero<kExact>(qp, q0 + r, g.sq, cc + c, d);
          dos[r * kPadD + c] =
              load_or_zero<kExact>(dop, q0 + r, g.sq, cc + c, d);
        }
        if (ch == 1) {
          for (int r = tid; r < kBQ; r += C::kThreads) {
            const int64_t qpos = q0 + r;
            lse_s[r] = qpos < g.sq ? lse[bh * g.sq + qpos] : 0.f;
            d_s[r] = qpos < g.sq ? delta[bh * g.sq + qpos] : 0.f;
          }
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < D; ++c) {
          const float4 ka =
              *reinterpret_cast<const float4*>(kt + c * kPadKey + ty * 8);
          const float4 kb =
              *reinterpret_cast<const float4*>(kt + c * kPadKey + ty * 8 + 4);
          const float4 va =
              *reinterpret_cast<const float4*>(vt + c * kPadKey + ty * 8);
          const float4 vb =
              *reinterpret_cast<const float4*>(vt + c * kPadKey + ty * 8 + 4);
          const float kv[kRows] = {ka.x, ka.y, ka.z, ka.w,
                                   kb.x, kb.y, kb.z, kb.w};
          const float vv[kRows] = {va.x, va.y, va.z, va.w,
                                   vb.x, vb.y, vb.z, vb.w};
          float qv[NC], ov[NC];
#pragma unroll
          for (int jj = 0; jj < NC; ++jj) {
            qv[jj] = qs[(tx + TX * jj) * kPadD + c];
            ov[jj] = dos[(tx + TX * jj) * kPadD + c];
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int jj = 0; jj < NC; ++jj) {
              s[i][jj] = fmaf(kv[i], qv[jj], s[i][jj]);
              dp[i][jj] = fmaf(vv[i], ov[jj], dp[i][jj]);
            }
        }
      }

      if (tile_unmasked<kBQ, BK>(g, q0, k0))
        p_ds_tile<false, TX, kPadKey>(s, dp, lse_s, d_s, pt, dst, g, q0,
                                      k0 + ty * 8, ty * 8, tx);
      else
        p_ds_tile<true, TX, kPadKey>(s, dp, lse_s, d_s, pt, dst, g, q0,
                                     k0 + ty * 8, ty * 8, tx);
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q, Q and dO holding the block's own slice
#pragma unroll 2
      for (int qq = 0; qq < kBQ; ++qq) {
        const float4 pa =
            *reinterpret_cast<const float4*>(pt + qq * kPadKey + ty * 8);
        const float4 pb =
            *reinterpret_cast<const float4*>(pt + qq * kPadKey + ty * 8 + 4);
        const float4 sa =
            *reinterpret_cast<const float4*>(dst + qq * kPadKey + ty * 8);
        const float4 sb =
            *reinterpret_cast<const float4*>(dst + qq * kPadKey + ty * 8 + 4);
        const float pv[kRows] = {pa.x, pa.y, pa.z, pa.w,
                                 pb.x, pb.y, pb.z, pb.w};
        const float sv[kRows] = {sa.x, sa.y, sa.z, sa.w,
                                 sb.x, sb.y, sb.z, sb.w};
        float ov[NA], qv[NA];
#pragma unroll
        for (int c = 0; c < NA; ++c) {
          ov[c] = dos[qq * kPadD + tx + TX * c];
          qv[c] = qs[qq * kPadD + tx + TX * c];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < NA; ++c) {
            acc_v[i][c] = fmaf(pv[i], ov[c], acc_v[i][c]);
            acc_k[i][c] = fmaf(sv[i], qv[c], acc_k[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t kpos = k0 + ty * 8 + i;
    if (kpos < g.skv)
      io.store(out_row * g.skv + kpos, col, d, acc_k[i], acc_v[i]);
  }
}

// launches attn_dkv_kernel for the compiled width of g.d: grid (output
// rows, kv tiles, slices), each block summing rows_per_block query rows;
// kv tile 0 first, under a causal mask it feeds the most q tiles
template <typename T, class IO>
struct DkvLauncher {
  const T *q, *k, *v, *dout;
  const float *lse, *delta;
  long long out_rows;
  int rows_per_block;
  Geometry g;
  IO io;
  cudaStream_t stream;

  template <int D, bool kExact, bool kWide>
  cudaError_t go() const {
    using C = DkvTiles<D>;
    const auto kernel = attn_dkv_kernel<T, D, kExact, kWide, IO>;
    const cudaError_t err = allow_smem(kernel, C::smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)out_rows,
                    (unsigned)((g.skv + C::BK - 1) / C::BK),
                    (unsigned)n_slices(g.d));
    kernel<<<grid, C::kThreads, C::smem, stream>>>(q, k, v, dout, lse, delta,
                                                   g, rows_per_block, io);
    return cudaGetLastError();
  }
};

// out_rows: kv_rows (a block sums the group) or rows (one query row a block)
template <typename T, class IO>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       long long rows, long long out_rows, const Geometry& g,
                       const IO& io, cudaStream_t stream) {
  const DkvLauncher<T, IO> f{
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      out_rows, (int)(rows / out_rows), g, io, stream};
  return dispatch_width(g.d, f);
}

}  // namespace flash
