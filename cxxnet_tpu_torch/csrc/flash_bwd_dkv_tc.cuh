// The tensor-core dK/dV kernel body shared by flash_bwd_dkv.cu (the flash
// backward's dK and dV) and ring_dkv_step.cu (one ring step's dK/dV
// contribution): one block owns 64 keys of one (batch, kv head) row and
// one slice of the head dim, loops over rows_per_block of the query rows
// that share the kv row (the flash: the whole GQA group, summed in the
// block; a ring step: one) and, for each, over the q tiles the mask keeps.
// Each warp owns 16 of the keys and D / NW of the columns, and
// accumulates dV += P^T dO and dK += scale dS^T Q for them in registers.
// Every product runs on the tensor cores as m16n8k8 TF32 mma.sync, fp32
// operands in 3xTF32 (flash_mma.cuh). Where the accumulators start and
// where they go is the IO policy's: the flash's start from 0 and are
// stored in the input dtype; a ring step reads its f32 carries and writes
// them back. flash_bwd_dkv.cu's header states the layout per width and
// the bound, ring_dkv_step.cu's what the ring changes.
//
// The IO policy provides, for a key row `row` of the block's output rows
// (b nkv skv) and the two columns col, col + 1 a lane holds:
//   init(row, col, d, acc_k[2], acc_v[2])   the accumulators' start
//   store(row, col, d, acc_k[2], acc_v[2])  the row's result (col < d)
//   kInPlace  true when store writes back where init read: a block that
//             feeds no q tile then returns at once (a ring step's
//             carries); false, it stores its start (the flash dK/dV's
//             zeros)

#pragma once

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace flash {

// Per-width layout (flash_bwd_dkv.cu's header gives the reasons). K and V
// stay in shared memory for the whole block; Q, dO, lse and D stream
// through kStages stages of BQ query rows. At width 256 two warps share
// each 16 keys, each owning 128 columns of dK and dV (both recompute the
// 16 x BQ scores). Above 256 (kWide) every (query row, q tile, 256-column
// chunk) restages K, V, Q and dO in its one stage.
template <int D, bool kWide>
struct DkvTcTiles {
  static constexpr int BK = 64;                   // keys per block
  static constexpr int NW = D == 256 ? 2 : 1;     // warps per 16 keys
  static constexpr int kWarps = BK / 16 * NW;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BQ = D <= 64 ? 64 : D == 128 ? 16 : 32;
  static constexpr int kStages = D == 256 ? 1 : 2;
  // row stride of every tile in elements, 16 bytes past the row (as dQ's)
  template <typename T>
  __host__ __device__ static constexpr int stride() {
    return D + 16 / (int)sizeof(T);
  }
  // K, V [BK][S]; per stage Q, dO [BQ][S]; then per stage lse, D [BQ] f32
  template <typename T>
  __host__ __device__ static constexpr size_t smem() {
    return sizeof(T) * (size_t)stride<T>() * (2 * BK + 2 * BQ * kStages) +
           sizeof(float) * 2 * BQ * kStages;
  }
};

// P^T = exp(S^T scale - lse) in place of the lane's S^T fragments (keys
// key, key + 8; query columns qc + 8 n, + 1 of the tile at local row q0),
// with the tile's lse in shared memory. kMasked: test every pair; a masked
// pair, a query row past sq or a key past skv gets p = 0
template <bool kMasked, int NT>
__device__ __forceinline__ void p_frag(float (&s)[NT][4], const float* lse_s,
                                       const Geometry& g, int64_t q0, int qc,
                                       int64_t key) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = qc + 8 * n + e % 2;
      s[n][e] = (!kMasked || pair_kept(g, q0 + c, key + 8 * (e / 2)))
                    ? expf(s[n][e] * g.scale - lse_s[c])
                    : 0.f;
    }
}

// dS^T = P^T (dP^T - D) scale in place of the dP^T fragments, D of the
// tile's query columns in shared memory; 0 wherever p is
template <int NT>
__device__ __forceinline__ void ds_t_frag(float (&dp)[NT][4],
                                          const float (&p)[NT][4],
                                          const float* dl_s, int qc,
                                          float scale) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[n][e] = p[n][e] * (dp[n][e] - dl_s[qc + 8 * n + e % 2]) * scale;
}

template <typename T, int D, bool kExact, bool kWide, class IO>
__global__ void __launch_bounds__(DkvTcTiles<D, kWide>::kThreads)
attn_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, const Geometry g,
                   const int rows_per_block, const int mode, const IO io) {
  using C = DkvTcTiles<D, kWide>;
  constexpr int kThreads = C::kThreads, BK = C::BK, BQ = C::BQ;
  constexpr int kStages = C::kStages, NW = C::NW;
  constexpr int S = C::template stride<T>();
  constexpr int NT = BQ / 8, NO = D / NW / 8;
  // the row stride; the compiled width itself when d is one of them
  const int d = kExact ? D : g.d;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + BK * S;
  T* qdo = vs + BK * S;  // stage s: Q at qdo + 2 s BQ S, dO BQ S after
  float* lds = reinterpret_cast<float*>(qdo + 2 * kStages * BQ * S);
  // stage s: lse at lds + 2 s BQ, D BQ after

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane / 4, t4 = lane % 4;
  const int r0 = warp % (BK / 16) * 16;   // the warp's keys in the tile
  const int cw = warp / (BK / 16) * (D / NW);  // and its first column
  // the block's output row; its first query row and its k/v row
  const int64_t out_row = blockIdx.x;
  const int64_t row0 = out_row * rows_per_block;
  const int64_t bkv = row0 / g.group;
  const int64_t k0 = (int64_t)blockIdx.y * BK;
  const int64_t key = k0 + r0 + grp;
  // the slice of the head dim whose dK / dV this block owns; the chunks of
  // the S / dP pass, its own last so that the stage holds it for the
  // dV / dK products
  const int slice = kWide ? (int)blockIdx.z : 0;
  const int col0 = slice * D + cw;
  const int n_chunks = kWide ? n_slices(d) : 1;
  const T* kp = k + bkv * g.skv * d;
  const T* vp = v + bkv * g.skv * d;

  int64_t q_begin, q_end;
  q_tiles_for_kv<BQ, BK>(g.kv_off + k0, g.q_off, g.sq, g.causal, g.window,
                         &q_begin, &q_end);
  const int qb = (int)q_begin, qe = (int)q_end;
  const int n_items = qe > qb ? rows_per_block * (qe - qb) * n_chunks : 0;
  // in-place carries whose block feeds no q tile stay as they are, unread
  if constexpr (IO::kInPlace) {
    if (n_items == 0) return;
  }

  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t kpos = key + 8 * i;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float ak[2] = {0.f, 0.f}, av[2] = {0.f, 0.f};
      if (kpos < g.skv)
        io.init(out_row * g.skv + kpos, col0 + 8 * n + 2 * t4, d, ak, av);
      acc_k[n][2 * i] = ak[0];
      acc_k[n][2 * i + 1] = ak[1];
      acc_v[n][2 * i] = av[0];
      acc_v[n][2 * i + 1] = av[1];
    }
  }

  // an item of the ring: query row gi of the block's rows, q tile t, chunk
  // ch; the items run chunk fastest, then q tile, then query row
  struct Item {
    int gi, t, ch;
  };
  auto advance = [&](Item& x) {
    if (++x.ch == n_chunks) {
      x.ch = 0;
      if (++x.t == qe) {
        x.t = qb;
        ++x.gi;
      }
    }
  };
  Item nx{0, qb, 0};  // the next item to copy

  // starts the copies of item nx into stage st
  auto issue = [&](int st) {
    const int64_t bh = row0 + nx.gi;
    const int64_t qt0 = (int64_t)nx.t * BQ;
    const int cc = kWide ? (slice + nx.ch + 1) % n_chunks * D : 0;
    T* qst = qdo + 2 * st * BQ * S;
    if (kWide) {
      copy_tile<BK, D, S, kThreads>(ks, kp, k0, g.skv, cc, d, mode, tid);
      copy_tile<BK, D, S, kThreads>(vs, vp, k0, g.skv, cc, d, mode, tid);
    }
    copy_tile<BQ, D, S, kThreads>(qst, q + bh * g.sq * d, qt0, g.sq, cc, d,
                                  mode, tid);
    copy_tile<BQ, D, S, kThreads>(qst + BQ * S, dout + bh * g.sq * d, qt0,
                                  g.sq, cc, d, mode, tid);
    copy_row_f32<BQ, kThreads>(lds + 2 * st * BQ, lse + bh * g.sq, qt0, g.sq,
                               tid);
    copy_row_f32<BQ, kThreads>(lds + 2 * st * BQ + BQ, delta + bh * g.sq,
                               qt0, g.sq, tid);
    advance(nx);
  };

  if (!kWide && n_items > 0) {
    copy_tile<BK, D, S, kThreads>(ks, kp, k0, g.skv, 0, d, mode, tid);
    copy_tile<BK, D, S, kThreads>(vs, vp, k0, g.skv, 0, d, mode, tid);
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_items) issue(st);
    cp_async_commit();
  }

  float s[NT][4], dp[NT][4];
  Item cur{0, qb, 0};
  for (int it = 0; it < n_items; ++it, advance(cur)) {
    const int st = kStages == 1 ? 0 : it % kStages;
    if constexpr (kStages == 1) {
      issue(0);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      cp_async_wait<kStages - 2>();
    }
    __syncthreads();  // item it has landed; every warp is done with it - 1
    if constexpr (kStages > 1) {
      // into the stage item it - 1 used
      if (it + kStages - 1 < n_items) issue((it + kStages - 1) % kStages);
      cp_async_commit();
    }
    const T* qst = qdo + 2 * st * BQ * S;
    const T* dost = qst + BQ * S;
    const int ch = cur.ch;
    if (ch == 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
    mma_rows_t<NT, D, S>(s, ks + r0 * S, qst, lane);
    if (ch < n_chunks - 1) {
      mma_rows_t<NT, D, S>(dp, vs + r0 * S, dost, lane);
    } else {
      // P^T and dV += P^T dO before dP^T, so that S^T and dP^T are not
      // both live beside the products' fragments
      const int64_t qt0 = (int64_t)cur.t * BQ;
      const float* lse_s = lds + 2 * st * BQ;
      if (tile_unmasked<BQ, BK>(g, qt0, k0))
        p_frag<false>(s, lse_s, g, qt0, 2 * t4, key);
      else
        p_frag<true>(s, lse_s, g, qt0, 2 * t4, key);
      mma_p_x<NT, NO, S>(acc_v, s, dost + cw, lane);  // dV += P^T dO
      mma_rows_t<NT, D, S>(dp, vs + r0 * S, dost, lane);
      ds_t_frag(dp, s, lse_s + BQ, 2 * t4, g.scale);
      mma_p_x<NT, NO, S>(acc_k, dp, qst + cw, lane);  // dK += dS^T Q
    }
    if constexpr (kStages == 1) __syncthreads();  // before the next copies
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t kpos = key + 8 * i;
    if (kpos >= g.skv) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float ak[2] = {acc_k[n][2 * i], acc_k[n][2 * i + 1]};
      const float av[2] = {acc_v[n][2 * i], acc_v[n][2 * i + 1]};
      io.store(out_row * g.skv + kpos, col0 + 8 * n + 2 * t4, d, ak, av);
    }
  }
}

// launches attn_dkv_tc_kernel for the compiled width of g.d: grid (output
// rows, kv tiles, slices), each block summing rows_per_block query rows;
// kv tile 0 first, under a causal mask it feeds the most q tiles
template <typename T, class IO>
struct DkvTcLauncher {
  const T *q, *k, *v, *dout;
  const float *lse, *delta;
  long long out_rows;
  int rows_per_block;
  Geometry g;
  IO io;
  cudaStream_t stream;

  template <int D, bool kExact, bool kWide>
  cudaError_t go() const {
    using C = DkvTcTiles<D, kWide>;
    const auto kernel = attn_dkv_tc_kernel<T, D, kExact, kWide, IO>;
    const size_t smem = C::template smem<T>();
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const void* ptrs[] = {q, k, v, dout};
    const int mode = copy_mode(ptrs, 4, g.d, (int)sizeof(T));
    const dim3 grid((unsigned)out_rows,
                    (unsigned)((g.skv + C::BK - 1) / C::BK),
                    (unsigned)n_slices(g.d));
    kernel<<<grid, C::kThreads, smem, stream>>>(q, k, v, dout, lse, delta, g,
                                                rows_per_block, mode, io);
    return cudaGetLastError();
  }
};

// out_rows: kv_rows, a block sums the group of rows / out_rows query rows
template <typename T, class IO>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, long long rows,
                          long long out_rows, const Geometry& g, const IO& io,
                          cudaStream_t stream) {
  const DkvTcLauncher<T, IO> f{
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      out_rows, (int)(rows / out_rows), g, io, stream};
  return dispatch_width(g.d, f);
}

}  // namespace flash
