// The tensor-core forward kernel body shared by flash_fwd.cu (the flash
// forward) and ring_fwd_step.cu (one ring step's online-softmax update):
// one block owns 64 query rows of one (batch, head) row and one slice of
// the head dim; each of its 4 warps owns 16 of the rows and carries the
// online softmax (m, l, acc) for them in registers over the kv tiles the
// mask keeps. S = Q K^T and P V run on the tensor cores as m16n8k8 TF32
// mma.sync, fp32 operands in 3xTF32 (flash_mma.cuh). Where the carry starts
// and where it goes is the IO policy's: the flash forward starts from
// (NEG_INF, 0, 0) and writes out = acc / l and lse; a ring step reads the
// carry of the previous step and writes it back. flash_fwd.cu's header
// states the layout per width and the bound, ring_fwd_step.cu's what the
// ring changes.
//
// The IO policy provides, for a query row `row` of the flattened (b h sq)
// axis, the two columns col, col + 1 a lane holds (the C fragment's
// column pair (2t, 2t + 1) of an 8-column tile) and its row statistics:
//   init_stats(row, m, l)            the statistics the row starts from
//   init_acc(row, col, d, acc[2])    the accumulator it starts from
//   store_acc(row, col, d, l, acc[2])  the row's result (columns < d only)
//   store_stats(row, m, l)           the row's statistics; called by one
//                                    lane of the block of slice 0

#pragma once

#include <cooperative_groups.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace flash {

// Head dims above 128 run in slices of this many output columns, one block
// each, grouped into thread-block clusters that share the score product
constexpr int kFwdSliceWidth = 128;
constexpr int kFwdMaxCluster = 8;  // the portable cluster size

// slices of kFwdSliceWidth columns a head dim above 128 runs in (1 below)
__host__ __device__ __forceinline__ int fwd_slices(int d) {
  return d <= kFwdSliceWidth ? 1
                             : (d + kFwdSliceWidth - 1) / kFwdSliceWidth;
}

// blocks per cluster for n slices: the largest divisor of n up to
// kFwdMaxCluster. Each block of a cluster forms the scores over n / cluster
// of the head dim's chunks; a cluster of one forms them alone
inline int fwd_cluster(int n) {
  for (int c = n < kFwdMaxCluster ? n : kFwdMaxCluster; c > 1; --c)
    if (n % c == 0) return c;
  return 1;
}

// Per-width layout (flash_fwd.cu's header gives the reasons). Q stays in
// shared memory for the whole block; K and V stream through kStages
// stages of BK keys. kWide: slices of 128 columns in a cluster, with two
// exchange buffers of the block's partial scores; kMulti: a block forms
// its scores over more than one chunk and restages Q with each.
template <int W, bool kWide, bool kMulti, typename T>
struct FwdTcTiles {
  static constexpr int kWarps = 4;  // 16 query rows each
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BK = W <= 64 ? 64 : 32;
  static constexpr int kStages =
      kMulti || (kWide && sizeof(T) == sizeof(float)) ? 1 : 2;
  // row stride of every tile in elements, 16 bytes past the row, so that
  // ldmatrix's 8 rows and the permuted B reads hit 32 distinct banks
  static constexpr int S = W + 16 / (int)sizeof(T);
  static constexpr int NT = BK / 8, NO = W / 8;
  // a warp's partial scores as C fragments, [NT][32 lanes][4] f32
  static constexpr int kXchgWarp = NT * 32 * 4;
  // Q [kBQ][S]; per stage K, V [BK][S]; kWide: exchange [2][kWarps] warps
  static constexpr size_t smem =
      sizeof(T) * (size_t)S * (kBQ + 2 * BK * kStages) +
      (kWide ? sizeof(float) * 2 * kWarps * kXchgWarp : 0);
};

// acc[n] += A B_n^T over W columns, the score product S = Q K^T: A the
// warp's 16 rows at a, B_n the 8 rows at b + 8 n S (row-major tiles of
// row stride S). bf16 tiles take mma_rows_t (one exact TF32 product a
// k-step). fp32 tiles read each fragment with one ldmatrix and run 3xTF32
// with every pair of k-steps (6 products) in a fresh accumulator, added to
// acc by one rounded f32 addition: summed straight into acc, the tensor
// cores' rounding toward zero drifted the scores by up to 24 ulps over 64
// columns, beyond the forward's bar of 8 f32 epsilons of the largest |out|
// on the card (a ragged non-causal L 1,000 prefill)
template <int NT, int W, int S, typename T>
__device__ __forceinline__ void score_rows(float (&acc)[NT][4], const T* a,
                                           const T* b, int lane) {
  if constexpr (!std::is_same<T, float>::value) {
    mma_rows_t<NT, W, S>(acc, a, b, lane);
  } else {
    static_assert(NT % 2 == 0 && W % 16 == 0, "tile shape");
    const int l8 = lane % 8, l8h = (lane / 8) % 2, l16 = lane / 16;
    const float* pa = a + (l8 + 8 * l8h) * S + 4 * l16;
    const float* pb = b + (l8 + 8 * l16) * S + 4 * l8h;
#pragma unroll 1
    for (int k0 = 0; k0 < W; k0 += 16) {
      uint32_t r[4];
      FragA<true> fa[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ldmatrix_x4(r, pa + k0 + 8 * h);
#pragma unroll
        for (int i = 0; i < 4; ++i) fa[h].set(i, __uint_as_float(r[i]));
      }
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        float t[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ldmatrix_x4(r, pb + n * 8 * S + k0 + 8 * h);
          FragB<true> f[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            f[c].set(0, __uint_as_float(r[2 * c]));
            f[c].set(1, __uint_as_float(r[2 * c + 1]));
            mma_tf32(t[c], fa[h].small, f[c].big);
            mma_tf32(t[c], fa[h].big, f[c].small);
            mma_tf32(t[c], fa[h].big, f[c].big);
          }
        }
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n + c][i] += t[c][i];
      }
    }
  }
}

// One kv tile folded into the lane's rows row, row + 8 of the online
// softmax: S scaled, the row max and sum reduced over the 4 lanes of the
// row group, the carry rescaled, S replaced by P in place (keys
// key + 8 n, + 1). kMasked: test every pair (a tile on the diagonal, the
// window's edge or a ragged edge); a masked score is NEG_INF and its mass
// is set to 0 outright (_fwd_step_kernel, cxxnet_tpu/ops/ring_flash.py:
// 111-114), so a row whose keys in the tile are all masked keeps its carry
// unchanged. The exp is __expf (ex2.approx of x log2(e), within a few
// ulps): it gives exactly 1 at 0, so a row whose max did not move keeps
// its carry bitwise, and it ran faster than expf at the same error against
// the bar
template <bool kMasked, int NT, int NO>
__device__ __forceinline__ void fold_frag(float (&s)[NT][4], float (&m)[2],
                                          float (&l)[2], float (&acc)[NO][4],
                                          const Geometry& g, int64_t row,
                                          int64_t key) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e / 2;
      s[n][e] = (!kMasked || pair_kept(g, row + 8 * i, key + 8 * n + e % 2))
                    ? s[n][e] * g.scale
                    : kNegInf;
      mx[i] = fmaxf(mx[i], s[n][e]);
    }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    alpha[i] = __expf(m[i] - m_new);
    m[i] = m_new;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e / 2;
      s[n][e] = kMasked && s[n][e] <= 0.5f * kNegInf
                    ? 0.f
                    : __expf(s[n][e] - m[i]);
      sum[i] += s[n][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    l[i] = l[i] * alpha[i] + sum[i];
  }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e / 2];
}

// Two blocks an SM: with that bound ptxas keeps up to 255 registers a
// thread; without it it kept fewer and the kernel ran slower
template <typename T, int W, bool kExact, bool kWide, bool kMulti, class IO>
__global__ void __launch_bounds__(FwdTcTiles<W, kWide, kMulti, T>::kThreads, 2)
attn_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const Geometry g, const int mode,
                   const int cluster, const IO io) {
  using C = FwdTcTiles<W, kWide, kMulti, T>;
  constexpr int kThreads = C::kThreads, BK = C::BK, kStages = C::kStages;
  constexpr int S = C::S, NT = C::NT, NO = C::NO;
  // the row stride; the compiled width itself when d is one of them
  const int d = kExact ? W : g.d;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* kvs = qs + kBQ * S;  // stage s: K at kvs + 2 s BK S, V BK S after
  float* xs = reinterpret_cast<float*>(kvs + 2 * kStages * BK * S);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane / 4, t4 = lane % 4;
  const int64_t bh = blockIdx.x;
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * kBQ;
  // the slice of the head dim whose accumulator this block owns, its rank
  // in the cluster, and the chunks of the head dim whose partial scores it
  // forms: rank, rank + cluster, ... (its own slice when per == 1)
  const int slice = kWide ? (int)blockIdx.z : 0;
  const int col0 = slice * W;
  const int rank = kWide ? slice % cluster : 0;
  const int per = kWide ? (int)gridDim.z / cluster : 1;
  const T* qp = q + bh * g.sq * d;
  const T* kp = k + bh / g.group * g.skv * d;
  const T* vp = v + bh / g.group * g.skv * d;
  const int r0 = warp * 16;  // the warp's rows in the tile
  const int64_t row = q0 + r0 + grp;

  // the kv tiles _tile_needed keeps
  int64_t kv_begin, kv_end;
  kv_tiles_for_q<kBQ, BK>(g.q_off + q0, g.kv_off, g.skv, g.causal, g.window,
                          &kv_begin, &kv_end);
  const int kb = (int)kv_begin;
  const int n_items = kv_end > kv_begin ? ((int)kv_end - kb) * per : 0;

  float m[2], l[2], acc[NO][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t qpos = row + 8 * i;
    m[i] = kNegInf;
    l[i] = 0.f;
    if (qpos < g.sq) io.init_stats(bh * g.sq + qpos, m[i], l[i]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      float a[2] = {0.f, 0.f};
      if (qpos < g.sq) io.init_acc(bh * g.sq + qpos, col0 + 8 * n + 2 * t4, d,
                                   a);
      acc[n][2 * i] = a[0];
      acc[n][2 * i + 1] = a[1];
    }
  }
  // an item of the ring: kv tile j, the block's chunk ci, chunk fastest
  struct Item {
    int j, ci;
  };
  auto advance = [&](Item& x) {
    if (++x.ci == per) {
      x.ci = 0;
      ++x.j;
    }
  };
  Item nx{kb, 0};  // the next item to copy

  // starts the copies of item nx into stage st: K of its chunk, V of the
  // block's own slice with the last chunk, Q of its chunk when kMulti
  auto issue = [&](int st) {
    const int64_t kt0 = (int64_t)nx.j * BK;
    const int cc = (rank + nx.ci * cluster) * W;
    T* ks = kvs + 2 * st * BK * S;
    if (kMulti)
      copy_tile<kBQ, W, S, kThreads>(qs, qp, q0, g.sq, cc, d, mode, tid);
    copy_tile<BK, W, S, kThreads>(ks, kp, kt0, g.skv, cc, d, mode, tid);
    if (nx.ci == per - 1)
      copy_tile<BK, W, S, kThreads>(ks + BK * S, vp, kt0, g.skv, col0, d,
                                    mode, tid);
    advance(nx);
  };

  if (!kMulti && n_items > 0)
    copy_tile<kBQ, W, S, kThreads>(qs, qp, q0, g.sq, col0, d, mode, tid);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_items) issue(st);
    cp_async_commit();
  }

  float s[NT][4];
  Item cur{kb, 0};
  int parity = 0;  // the exchange buffer of this kv tile
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
    const int64_t k0 = (int64_t)cur.j * BK;
    if (cur.ci == 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
    score_rows<NT, W, S>(s, qs + r0 * S, ks, lane);
    if (cur.ci == per - 1) {
      if (kWide && cluster > 1) {
        // the cluster's partial scores summed in rank order, so that every
        // block of the cluster (and every cluster) holds the same S
        namespace cg = cooperative_groups;
        cg::cluster_group cl = cg::this_cluster();
        float* mine = xs + (parity * C::kWarps + warp) * C::kXchgWarp;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<float4*>(mine + (n * 32 + lane) * 4) =
              make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
        cl.sync();  // every block's partial scores are written
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
        for (int r = 0; r < cluster; ++r) {
          const float4* theirs = reinterpret_cast<const float4*>(
              cl.map_shared_rank(mine, (unsigned)r));
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float4 x = theirs[n * 32 + lane];
            s[n][0] += x.x;
            s[n][1] += x.y;
            s[n][2] += x.z;
            s[n][3] += x.w;
          }
        }
        parity ^= 1;
      }
      if (tile_unmasked<kBQ, BK>(g, q0, k0))
        fold_frag<false>(s, m, l, acc, g, row, k0 + 2 * t4);
      else
        fold_frag<true>(s, m, l, acc, g, row, k0 + 2 * t4);
      mma_p_x<NT, NO, S>(acc, s, ks + BK * S, lane);
    }
    if constexpr (kStages == 1) __syncthreads();  // before the next copies
  }
  cp_async_wait<0>();
  // no block of a cluster leaves while another may read its scores
  if (kWide && cluster > 1) cooperative_groups::this_cluster().sync();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t qpos = row + 8 * i;
    if (qpos >= g.sq) continue;
    const int64_t r = bh * g.sq + qpos;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float a[2] = {acc[n][2 * i], acc[n][2 * i + 1]};
      io.store_acc(r, col0 + 8 * n + 2 * t4, d, l[i], a);
    }
    if (slice == 0 && t4 == 0) io.store_stats(r, m[i], l[i]);
  }
}

// launches attn_fwd_tc_kernel over q (rows, sq, d) for the compiled width
// of g.d: grid (rows, q tiles, slices), the last q tile first; above 128
// the slices of one q tile in clusters of `cluster` blocks
template <typename T, class IO>
struct FwdTcLauncher {
  const T *q, *k, *v;
  long long rows;
  Geometry g;
  IO io;
  cudaStream_t stream;

  template <int W, bool kExact, bool kWide, bool kMulti>
  cudaError_t go(int cluster) const {
    using C = FwdTcTiles<W, kWide, kMulti, T>;
    const auto kernel = attn_fwd_tc_kernel<T, W, kExact, kWide, kMulti, IO>;
    const cudaError_t err = allow_smem(kernel, C::smem);
    if (err != cudaSuccess) return err;
    const void* ptrs[] = {q, k, v};
    const int mode = copy_mode(ptrs, 3, g.d, (int)sizeof(T));
    const dim3 grid((unsigned)rows, (unsigned)((g.sq + kBQ - 1) / kBQ),
                    (unsigned)fwd_slices(g.d));
    if (cluster == 1) {
      kernel<<<grid, C::kThreads, C::smem, stream>>>(q, k, v, g, mode, 1,
                                                     io);
      return cudaGetLastError();
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(C::kThreads);
    cfg.dynamicSmemBytes = C::smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = (unsigned)cluster;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e =
        cudaLaunchKernelEx(&cfg, kernel, q, k, v, g, mode, cluster, io);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
};

// widths 16, 32, 64 and 128 (a head dim runs in the smallest that holds
// it, zero-filled past d); above 128 slices of 128 in clusters
template <typename T, class IO>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          long long rows, const Geometry& g, const IO& io,
                          cudaStream_t stream) {
  const FwdTcLauncher<T, IO> f{static_cast<const T*>(q),
                               static_cast<const T*>(k),
                               static_cast<const T*>(v), rows, g, io, stream};
  const int d = g.d;
  if (d <= 16)
    return d == 16 ? f.template go<16, true, false, false>(1)
                   : f.template go<16, false, false, false>(1);
  if (d <= 32)
    return d == 32 ? f.template go<32, true, false, false>(1)
                   : f.template go<32, false, false, false>(1);
  if (d <= 64)
    return d == 64 ? f.template go<64, true, false, false>(1)
                   : f.template go<64, false, false, false>(1);
  if (d <= 128)
    return d == 128 ? f.template go<128, true, false, false>(1)
                    : f.template go<128, false, false, false>(1);
  const int n = fwd_slices(d), cluster = fwd_cluster(n);
  return cluster == n ? f.template go<128, false, true, false>(cluster)
                      : f.template go<128, false, true, true>(cluster);
}

}  // namespace flash
