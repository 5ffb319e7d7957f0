// Flash attention forward for (b, h, L, d) tensors, fp32 and bf16, for sm_90a.
//
// Replaces the TPU kernel _fwd_kernel (cxxnet_tpu/ops/flash_attn.py:82,
// launched by _flash_fwd at :284), with its masking and tile skipping
// (_mask, _block_needed, :49-79) and its grouped-query row map
// (_kv_row_map, :257-265). For q (b, h, L, d) and k, v (b, nkv, L, d) with
// nkv | h, each query row of (batch, head) computes
//
//   out = softmax(scale * q k^T + mask) v,   lse = m + log(l)
//
// against kv head h / (h / nkv), with no broadcast copy of k or v. The mask
// keeps key positions < L and, when causal, qpos >= kpos and (window > 0)
// qpos - kpos < window. Every sum is f32 whatever the input dtype; out is
// stored in the input dtype and lse, the per-row logsumexp the backward
// will recompute P from, in f32 as (b, h, L).
//
// Design. The TPU walks the kv tiles as the last, sequential grid axis and
// carries (m, l, acc) in VMEM scratch. Here one block of 128 threads owns
// 64 query rows of one (batch, head) and loops over 64-key tiles itself,
// with (m, l, acc) in registers. Thread (ty, tx) = (tid / 16, tid % 16)
// owns rows ty*8 .. ty*8+7; of the 64 x 64 score tile it computes columns
// tx + 16 j (j < 4), and of the 64 x d accumulator columns tx + 16 j
// (j < d / 16). Both products are register-tiled f32 FMA from shared
// memory: the Q tile (staged once) and the P tile are stored transposed so
// that a thread's 8 rows are two float4 loads, K transposed and V row-major
// so that the 16 column lanes read 16 consecutive words. A row's max and
// sum are reduced over its 16 lanes with warp shuffles. Head dim 256 runs
// 256 threads, (ty, tx) = (tid / 32, tid % 32): 2 score columns and 8
// accumulator columns a thread, so that the accumulator stays at 8 x 8
// registers (8 x 16 would spill), and a warp owns 8 whole rows. Its tiles
// take 214 KB of shared memory, one block per SM. The masked score is
// the finite NEG_INF = -1e30 of the TPU kernel, so exp never sees
// inf - inf: a row whose first tiles are wholly masked takes p = 1 there,
// and the first real key rescales that by exp(-1e30 - m) = 0. Tiles wholly
// above the causal diagonal or wholly older than the window are never
// loaded (the loop bounds are _block_needed), which halves a causal
// prefill. The ragged last tile is masked in the kernel, with no padded
// copy: rows past L are computed from zeros and not stored. The last q
// tiles, which have the most kv tiles under a causal mask, are scheduled
// first.
//
// Bound. With TF32 off the port's fp32 runs outside the tensor cores, so
// the bound is the work over the card's f32 FMA rate (67 TFLOP/s, H100
// SXM): 4 d flops per (query, key) pair the mask keeps, about 8.6 GFLOP
// -> 0.13 ms for a causal prefill at b 8, h 8, L 1024, d 64. The bytes
// (q, k, v read once, out and lse written once: 67 MB there, 0.02 ms) are
// far below it. Each thread issues 12 shared loads per 32 FMAs in the
// score product, so shared-memory traffic, the exp per score and the
// block-wide barriers per tile keep the kernel a small multiple above the
// bound; mma.sync / wgmma on bf16 inputs, TMA staging and a pipelined K/V
// ring are later work.

// Head dims: see flash_common.cuh (any d <= 256, run in the next compiled
// width with zero-filled columns).

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
struct Tiles {
  static constexpr int TX = D == 256 ? 32 : 16;  // column lanes
  static constexpr int kThreads = 8 * TX;        // 8 row groups
  static constexpr int kRows = 8;                // query rows per thread
  static constexpr int NC = kBK / TX;            // score columns per thread
  static constexpr int NA = D / TX;              // accumulator columns
  // Q^T [D][kPadQ], K^T [D][kPadK], V [kBK][D], P^T [kBK][kPadQ]
  static constexpr size_t smem =
      sizeof(float) * (size_t)(D * kPadQ + D * kPadK + kBK * D + kBK * kPadQ);
};

template <typename T, int D, bool kExact>
__global__ void __launch_bounds__(Tiles<D>::kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int heads, int group, int64_t L,
                 int d_in, int causal, int64_t window, float scale) {
  // the row stride; the compiled width itself when d is one of them
  const int d = kExact ? D : d_in;
  using C = Tiles<D>;
  constexpr int TX = C::TX, kRows = C::kRows, NC = C::NC, kCols = C::NA;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* kt = qt + D * kPadQ;
  float* vs = kt + D * kPadK;
  float* pt = vs + kBK * D;

  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const int64_t bh = blockIdx.x;
  const int64_t batch = bh / heads, head = bh % heads;
  const int64_t kv_row = batch * (heads / group) + head / group;
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * kBQ;
  const T* qp = q + bh * L * d;
  const T* kp = k + kv_row * L * d;
  const T* vp = v + kv_row * L * d;

  for (int idx = tid; idx < kBQ * D; idx += C::kThreads) {
    const int r = idx / D, c = idx % D;
    qt[c * kPadQ + r] = load_or_zero<kExact>(qp, q0 + r, L, c, d);
  }

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // the kv tiles _block_needed keeps
  int64_t kv_begin, kv_end;
  kv_tiles_for_q<kBQ, kBK>(q0, L, causal, window, &kv_begin, &kv_end);

  for (int64_t j = kv_begin; j < kv_end; ++j) {
    const int64_t k0 = j * kBK;
    __syncthreads();  // the Q tile is in; the last tile's readers are done
    for (int idx = tid; idx < kBK * D; idx += C::kThreads) {
      const int r = idx / D, c = idx % D;
      kt[c * kPadK + r] = load_or_zero<kExact>(kp, k0 + r, L, c, d);
      vs[r * D + c] = load_or_zero<kExact>(vp, k0 + r, L, c, d);
    }
    __syncthreads();

    float s[kRows][NC];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + c * kPadQ + ty * 8);
      const float4 qb =
          *reinterpret_cast<const float4*>(qt + c * kPadQ + ty * 8 + 4);
      const float qv[kRows] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      float kv[NC];
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) kv[jj] = kt[c * kPadK + tx + TX * jj];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int jj = 0; jj < NC; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t qpos = q0 + ty * 8 + i;
      float rmax = kNegInf;
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) {
        s[i][jj] = keep(qpos, k0 + tx + TX * jj, L, causal, window)
                       ? s[i][jj] * scale
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
        s[i][jj] = expf(s[i][jj] - m_new);
        rsum += s[i][jj];
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int jj = 0; jj < NC; ++jj)
        pt[(tx + TX * jj) * kPadQ + ty * 8 + i] = s[i][jj];
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(pt + kk * kPadQ + ty * 8);
      const float4 pb =
          *reinterpret_cast<const float4*>(pt + kk * kPadQ + ty * 8 + 4);
      const float pv[kRows] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[kk * D + tx + TX * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t qpos = q0 + ty * 8 + i;
    if (qpos < L) {
      const float li = fmaxf(l[i], 1e-30f);
      T* op = out + (bh * L + qpos) * d;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (kExact || tx + TX * c < d)
          store_from_f32(op + tx + TX * c, acc[i][c] / li);
      if (tx == 0) lse[bh * L + qpos] = m[i] + logf(li);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int64_t batch, int heads, int kv_heads,
                   int64_t L, int d, int causal, int64_t window, float scale,
                   cudaStream_t stream) {
  using C = Tiles<D>;
  constexpr size_t smem = C::smem;
  // a head dim equal to the compiled width takes the instantiation with
  // compile-time strides and no column checks
  const auto kernel = d == D ? flash_fwd_kernel<T, D, true>
                              : flash_fwd_kernel<T, D, false>;
  // above 48 KB a block's dynamic shared memory must be allowed first
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(batch * heads), (unsigned)((L + kBQ - 1) / kBQ));
  kernel<<<grid, C::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, heads,
      heads / kv_heads, L, d, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int d, const void* q, const void* k, const void* v,
                         void* out, float* lse, int64_t batch, int heads,
                         int kv_heads, int64_t L, int causal, int64_t window,
                         float scale, cudaStream_t s) {
  switch (compiled_width(d)) {
    case 16:
      return launch<T, 16>(q, k, v, out, lse, batch, heads, kv_heads, L, d,
                           causal, window, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, out, lse, batch, heads, kv_heads, L, d,
                           causal, window, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, batch, heads, kv_heads, L, d,
                           causal, window, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, batch, heads, kv_heads, L, d,
                            causal, window, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, out, lse, batch, heads, kv_heads, L, d,
                            causal, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; 1 <= d <= 256; kv_heads divides heads;
// window > 0 only with causal. q, out (batch, heads, L, d), k, v (batch,
// kv_heads, L, d), lse (batch, heads, L) f32, all contiguous. Returns the
// cudaError_t of the launch (0 = success). Launches on `stream` and does
// not synchronise.
int cxxnet_flash_fwd(const void* q, const void* k, const void* v, void* out,
                     float* lse, int dtype, long long batch, int heads,
                     int kv_heads, long long L, int d, int causal,
                     long long window, float scale, void* stream) {
  if (batch <= 0 || L <= 0) return 0;
  const cudaError_t bad =
      check_args(batch, heads, kv_heads, L, d, causal, window);
  if (bad != cudaSuccess) return (int)bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dim<float>(d, q, k, v, out, lse, batch, heads,
                                    kv_heads, L, causal, window, scale, s);
  if (dtype == 1)
    return (int)dispatch_dim<__nv_bfloat16>(d, q, k, v, out, lse, batch,
                                            heads, kv_heads, L, causal,
                                            window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* cxxnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
