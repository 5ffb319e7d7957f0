// The tensor-core dQ kernel body shared by flash_bwd_dq.cu (the flash
// backward's dQ) and ring_dq_step.cu (one ring step's dQ contribution):
// one block owns 64 query rows of one (batch, head) row and one slice of
// the head dim; each of its 4 warps owns 16 of the rows and accumulates
// dQ += scale (P o (dP - D)) K for them in registers over the kv tiles the
// mask keeps. Every product runs on the tensor cores as m16n8k8 TF32
// mma.sync, fp32 operands in 3xTF32 (flash_mma.cuh). Where the accumulator
// starts and where it goes is the IO policy's: the flash dQ starts from 0
// and stores in the input dtype; a ring step reads its f32 carry and
// writes it back. flash_bwd_dq.cu's header states the layout per width
// and the bound, ring_dq_step.cu's what the ring changes.
//
// The IO policy provides, for a query row `row` of the flattened (b h sq)
// axis and the two columns col, col + 1 a lane holds:
//   init(row, col, d, acc[2])   the accumulator the row starts from
//   store(row, col, d, acc[2])  the row's result (columns < d only)
//   kInPlace  true when store writes back where init read: a block that
//             keeps no kv tile then returns at once (a ring step's carry);
//             false, it stores its start (the flash dQ's zeros)

#pragma once

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace flash {

// Per-width layout (flash_bwd_dq.cu's header gives the reasons). Q and dO
// stay in shared memory for the whole block; K and V stream through
// kStages stages of BK keys. Above 256 (kWide) every (kv tile, 256-column
// chunk) restages Q, dO, K and V in its one stage.
template <int D, bool kWide>
struct DqTcTiles {
  static constexpr int kWarps = 4;  // 16 query rows each
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BK = D == 128 ? 16 : 32;
  static constexpr int kStages = D == 256 ? 1 : 2;
  // row stride of every tile in elements: 16 bytes past the row, so that
  // ldmatrix's 8 rows and the permuted B reads hit 32 distinct banks
  template <typename T>
  __host__ __device__ static constexpr int stride() {
    return D + 16 / (int)sizeof(T);
  }
  // Q, dO [kBQ][S]; per stage K, V [BK][S]
  template <typename T>
  __host__ __device__ static constexpr size_t smem() {
    return sizeof(T) * (size_t)stride<T>() * (2 * kBQ + 2 * BK * kStages);
  }
};

// dS = P (dP - D) scale in place of the lane's S fragments (rows row,
// row + 8; keys key + 8 n, + 1), P = exp(S scale - lse). kMasked: test
// every pair (a diagonal, window-edge or ragged tile); a masked pair gets
// p = 0 outright
template <bool kMasked, int NT>
__device__ __forceinline__ void ds_frag(float (&s)[NT][4],
                                        const float (&dp)[NT][4],
                                        const float (&lse_r)[2],
                                        const float (&dl_r)[2],
                                        const Geometry& g, int64_t row,
                                        int64_t key) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e / 2;
      const float p =
          (!kMasked || pair_kept(g, row + 8 * i, key + 8 * n + e % 2))
              ? expf(s[n][e] * g.scale - lse_r[i])
              : 0.f;
      s[n][e] = p * (dp[n][e] - dl_r[i]) * g.scale;
    }
}

template <typename T, int D, bool kExact, bool kWide, class IO>
__global__ void __launch_bounds__(DqTcTiles<D, kWide>::kThreads)
attn_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, const Geometry g,
                  const int mode, const IO io) {
  using C = DqTcTiles<D, kWide>;
  constexpr int kThreads = C::kThreads, BK = C::BK, kStages = C::kStages;
  constexpr int S = C::template stride<T>();
  constexpr int NT = BK / 8, NO = D / 8;
  // the row stride; the compiled width itself when d is one of them
  const int d = kExact ? D : g.d;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + kBQ * S;
  T* kvs = dos + kBQ * S;  // stage s: K at kvs + 2 s BK S, V BK S after

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane / 4, t4 = lane % 4;
  const int64_t bh = blockIdx.x;
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * kBQ;
  // the slice of the head dim whose dQ this block owns; the chunks of the
  // S / dP pass, its own last so that the stage holds it for dQ += dS K
  const int slice = kWide ? (int)blockIdx.z : 0;
  const int col0 = slice * D;
  const int n_chunks = kWide ? n_slices(d) : 1;
  const T* qp = q + bh * g.sq * d;
  const T* dop = dout + bh * g.sq * d;
  const T* kp = k + bh / g.group * g.skv * d;
  const T* vp = v + bh / g.group * g.skv * d;
  const int r0 = warp * 16;  // the warp's rows in the tile
  const int64_t row = q0 + r0 + grp;

  int64_t kv_begin, kv_end;
  kv_tiles_for_q<kBQ, BK>(g.q_off + q0, g.kv_off, g.skv, g.causal, g.window,
                          &kv_begin, &kv_end);
  const int kb = (int)kv_begin;
  const int n_items = kv_end > kv_begin ? ((int)kv_end - kb) * n_chunks : 0;
  // an in-place carry whose block keeps no tile stays as it is, unread
  if constexpr (IO::kInPlace) {
    if (n_items == 0) return;
  }

  // lse and D of the lane's rows; rows past sq take 0 and are not stored
  float lse_r[2], dl_r[2], acc[NO][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t qpos = row + 8 * i;
    lse_r[i] = qpos < g.sq ? lse[bh * g.sq + qpos] : 0.f;
    dl_r[i] = qpos < g.sq ? delta[bh * g.sq + qpos] : 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float a[2] = {0.f, 0.f};
      if (qpos < g.sq) io.init(bh * g.sq + qpos, col0 + 8 * n + 2 * t4, d, a);
      acc[n][2 * i] = a[0];
      acc[n][2 * i + 1] = a[1];
    }
  }

  // an item of the ring: kv tile j, chunk ch, chunk fastest
  struct Item {
    int j, ch;
  };
  auto advance = [&](Item& x) {
    if (++x.ch == n_chunks) {
      x.ch = 0;
      ++x.j;
    }
  };
  Item nx{kb, 0};  // the next item to copy

  // starts the copies of item nx into stage st
  auto issue = [&](int st) {
    const int64_t kt0 = (int64_t)nx.j * BK;
    const int cc = kWide ? (slice + nx.ch + 1) % n_chunks * D : 0;
    T* ks = kvs + 2 * st * BK * S;
    if (kWide) {
      copy_tile<kBQ, D, S, kThreads>(qs, qp, q0, g.sq, cc, d, mode, tid);
      copy_tile<kBQ, D, S, kThreads>(dos, dop, q0, g.sq, cc, d, mode, tid);
    }
    copy_tile<BK, D, S, kThreads>(ks, kp, kt0, g.skv, cc, d, mode, tid);
    copy_tile<BK, D, S, kThreads>(ks + BK * S, vp, kt0, g.skv, cc, d, mode,
                                  tid);
    advance(nx);
  };

  if (!kWide && n_items > 0) {
    copy_tile<kBQ, D, S, kThreads>(qs, qp, q0, g.sq, 0, d, mode, tid);
    copy_tile<kBQ, D, S, kThreads>(dos, dop, q0, g.sq, 0, d, mode, tid);
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_items) issue(st);
    cp_async_commit();
  }

  float s[NT][4], dp[NT][4];
  Item cur{kb, 0};
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
    const T* ks = kvs + 2 * st * BK * S;
    const int ch = cur.ch;
    if (ch == 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
    mma_rows_t<NT, D, S>(s, qs + r0 * S, ks, lane);
    mma_rows_t<NT, D, S>(dp, dos + r0 * S, ks + BK * S, lane);
    if (ch == n_chunks - 1) {
      const int64_t k0 = (int64_t)cur.j * BK;
      if (tile_unmasked<kBQ, BK>(g, q0, k0))
        ds_frag<false>(s, dp, lse_r, dl_r, g, row, k0 + 2 * t4);
      else
        ds_frag<true>(s, dp, lse_r, dl_r, g, row, k0 + 2 * t4);
      mma_p_x<NT, NO, S>(acc, s, ks, lane);  // K of the block's own slice
    }
    if constexpr (kStages == 1) __syncthreads();  // before the next copies
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t qpos = row + 8 * i;
    if (qpos >= g.sq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float a[2] = {acc[n][2 * i], acc[n][2 * i + 1]};
      io.store(bh * g.sq + qpos, col0 + 8 * n + 2 * t4, d, a);
    }
  }
}

// launches attn_dq_tc_kernel over q (rows, sq, d) for the compiled width of
// g.d: grid (rows, q tiles, slices), the last q tile first
template <typename T, class IO>
struct DqTcLauncher {
  const T *q, *k, *v, *dout;
  const float *lse, *delta;
  long long rows;
  Geometry g;
  IO io;
  cudaStream_t stream;

  template <int D, bool kExact, bool kWide>
  cudaError_t go() const {
    using C = DqTcTiles<D, kWide>;
    const auto kernel = attn_dq_tc_kernel<T, D, kExact, kWide, IO>;
    const size_t smem = C::template smem<T>();
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const void* ptrs[] = {q, k, v, dout};
    const int mode = copy_mode(ptrs, 4, g.d, (int)sizeof(T));
    const dim3 grid((unsigned)rows, (unsigned)((g.sq + kBQ - 1) / kBQ),
                    (unsigned)n_slices(g.d));
    kernel<<<grid, C::kThreads, smem, stream>>>(q, k, v, dout, lse, delta, g,
                                                mode, io);
    return cudaGetLastError();
  }
};

template <typename T, class IO>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, long long rows,
                         const Geometry& g, const IO& io,
                         cudaStream_t stream) {
  const DqTcLauncher<T, IO> f{
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      rows, g, io, stream};
  return dispatch_width(g.d, f);
}

}  // namespace flash
