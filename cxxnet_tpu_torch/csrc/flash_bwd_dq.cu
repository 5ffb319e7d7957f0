// Flash attention backward, dQ, for (b, h, L, d) tensors, fp32 and bf16,
// for sm_90a.
//
// Replaces the TPU kernel _dq_kernel (cxxnet_tpu/ops/flash_attn.py:123,
// launched by _flash_bwd at :337). With P = exp(scale q k^T + mask - lse)
// recomputed from the forward's lse, dP = dO v^T and D = rowsum(dO o)
// (computed before the launch, as the JAX package computes it outside its
// kernels), each query row of (batch, head) gets
//
//   dq = scale * (P o (dP - D)) k
//
// against kv head h / (h / nkv), with the mask of the forward (keys < L;
// when causal, qpos >= kpos and (window > 0) qpos - kpos < window). Every
// sum is f32 whatever the input dtype; dq is stored in the input dtype.
//
// Design. The forward's layout (flash_fwd.cu): one block owns 64 query
// rows of one (batch, head) and loops over the 64-key tiles _block_needed
// keeps, the same loop bounds as the forward. Q and dO are staged once,
// transposed, so that a thread's 8 rows are two float4 loads; lse and D
// of its rows sit in registers. Per kv tile the block stages K^T and V^T,
// recomputes the 64 x 64 scores and dP in one pass over the head dim
// (thread (ty, tx) owns rows ty*8 .. ty*8+7 and columns tx + TX j), forms
// dS = P (dP - D) scale in registers, writes it transposed to shared
// memory, and accumulates dQ += dS K in registers (columns tx + TX c of
// the head dim, K read from the same transposed tile: the lanes read a
// stride of 65 words, 32 distinct banks). dQ is written once. A masked
// (query, key) gets p = 0 outright, so a wholly masked tile adds exact
// zeros and exp never sees NEG_INF. The ragged last tiles are masked in
// place: keys and query rows past L are staged as zeros and rows past L
// are never stored. No atomics: a backward is bitwise repeatable. The
// last q tiles, which have the most kv tiles under a causal mask, are
// scheduled first. Head dim 128 runs 256 threads (32 column lanes) so
// that the accumulators stay at 4 x 8 registers. Head dim 256 keeps the 32
// lanes (8 x 8 accumulator registers) and halves the key tile to 32: at 64
// keys its Q^T, dO^T, K^T, V^T and dS^T tiles would take 283 KB of shared
// memory, over the 227 KB a block may opt into; at 32 they take 211 KB.
//
// Bound. With TF32 off the port's fp32 runs outside the tensor cores: 6 d
// flops per (query, key) pair the mask keeps (S, dP, dQ), at 67 TFLOP/s.
// For the bench.py LM's step (b 8, h 8, L 2048, d 64, causal) that is
// 134 M pairs, 51.6 GFLOP -> 0.77 ms; the bytes (q, k, v, dO, lse, D read
// once, dq written once: 0.2 GB, 0.06 ms) are far below it. Per kv tile a
// thread issues 12 shared loads per 64 FMAs in the S/dP pass and 2 + D/TX
// per 8 D/TX in the dQ pass, plus an exp per score and three barriers;
// mma.sync / wgmma on bf16 inputs and a pipelined K/V ring are later work.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
struct Tiles {
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

template <typename T, int D, bool kExact>
__global__ void __launch_bounds__(Tiles<D>::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int heads, int group, int64_t L, int d_in, int causal,
                    int64_t window, float scale) {
  // the row stride; the compiled width itself when d is one of them
  const int d = kExact ? D : d_in;
  using C = Tiles<D>;
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
  const int64_t batch = bh / heads, head = bh % heads;
  const int64_t kv_row = batch * (heads / group) + head / group;
  const int64_t q0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * kBQ;
  const T* qp = q + bh * L * d;
  const T* dop = dout + bh * L * d;
  const T* kp = k + kv_row * L * d;
  const T* vp = v + kv_row * L * d;

  for (int idx = tid; idx < kBQ * D; idx += C::kThreads) {
    const int r = idx / D, c = idx % D;
    qt[c * kPadQ + r] = load_or_zero<kExact>(qp, q0 + r, L, c, d);
    dot[c * kPadQ + r] = load_or_zero<kExact>(dop, q0 + r, L, c, d);
  }
  // lse and D of the thread's rows; rows past L take 0 and are not stored
  float lse_r[kRows], d_r[kRows], acc[kRows][NA];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t qpos = q0 + ty * 8 + i;
    lse_r[i] = qpos < L ? lse[bh * L + qpos] : 0.f;
    d_r[i] = qpos < L ? delta[bh * L + qpos] : 0.f;
#pragma unroll
    for (int c = 0; c < NA; ++c) acc[i][c] = 0.f;
  }

  int64_t kv_begin, kv_end;
  kv_tiles_for_q<kBQ, BK>(q0, L, causal, window, &kv_begin, &kv_end);

  for (int64_t j = kv_begin; j < kv_end; ++j) {
    const int64_t k0 = j * BK;
    __syncthreads();  // Q, dO are in; the last tile's readers are done
    for (int idx = tid; idx < BK * D; idx += C::kThreads) {
      const int r = idx / D, c = idx % D;
      kt[c * kPadKT + r] = load_or_zero<kExact>(kp, k0 + r, L, c, d);
      vt[c * kPadKT + r] = load_or_zero<kExact>(vp, k0 + r, L, c, d);
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the thread's 8 x NC block
    float s[kRows][NC], dp[kRows][NC];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + c * kPadQ + ty * 8);
      const float4 qb =
          *reinterpret_cast<const float4*>(qt + c * kPadQ + ty * 8 + 4);
      const float4 da =
          *reinterpret_cast<const float4*>(dot + c * kPadQ + ty * 8);
      const float4 db =
          *reinterpret_cast<const float4*>(dot + c * kPadQ + ty * 8 + 4);
      const float qv[kRows] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
      const float dv[kRows] = {da.x, da.y, da.z, da.w, db.x, db.y, db.z, db.w};
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

    // dS = P (dP - D) scale, written transposed: dst[key][query row]
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t qpos = q0 + ty * 8 + i;
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) {
        const int kc = tx + TX * jj;
        const float p = (qpos < L && keep(qpos, k0 + kc, L, causal, window))
                            ? expf(s[i][jj] * scale - lse_r[i])
                            : 0.f;
        dst[kc * kPadQ + ty * 8 + i] = p * (dp[i][jj] - d_r[i]) * scale;
      }
    }
    __syncthreads();

    // dQ += dS K
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
    if (qpos < L) {
      T* op = dq + (bh * L + qpos) * d;
#pragma unroll
      for (int c = 0; c < NA; ++c)
        if (kExact || tx + TX * c < d)
          store_from_f32(op + tx + TX * c, acc[i][c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int64_t batch, int heads, int kv_heads,
                   int64_t L, int d, int causal, int64_t window, float scale,
                   cudaStream_t stream) {
  using C = Tiles<D>;
  // a head dim equal to the compiled width takes the instantiation with
  // compile-time strides and no column checks
  const auto kernel = d == D ? flash_bwd_dq_kernel<T, D, true>
                              : flash_bwd_dq_kernel<T, D, false>;
  // above 48 KB a block's dynamic shared memory must be allowed first
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(batch * heads), (unsigned)((L + kBQ - 1) / kBQ));
  kernel<<<grid, C::kThreads, C::smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), heads, heads / kv_heads, L, d, causal, window,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, int64_t batch,
                         int heads, int kv_heads, int64_t L, int d,
                         int causal, int64_t window, float scale,
                         cudaStream_t s) {
  switch (compiled_width(d)) {
    case 16:
      return launch<T, 16>(q, k, v, dout, lse, delta, dq, batch, heads,
                           kv_heads, L, d, causal, window, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, delta, dq, batch, heads,
                           kv_heads, L, d, causal, window, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dq, batch, heads,
                           kv_heads, L, d, causal, window, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dq, batch, heads,
                            kv_heads, L, d, causal, window, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, dout, lse, delta, dq, batch, heads,
                            kv_heads, L, d, causal, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dq); 1 <= d <= 256;
// kv_heads divides heads; window > 0 only with causal. q, dout, dq (batch,
// heads, L, d), k, v (batch, kv_heads, L, d), lse and delta (batch, heads,
// L) f32, all contiguous. Returns the cudaError_t of the launch (0 =
// success). Launches on `stream` and does not synchronise.
int cxxnet_flash_bwd_dq(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dq, int dtype,
                        long long batch, int heads, int kv_heads, long long L,
                        int d, int causal, long long window, float scale,
                        void* stream) {
  if (batch <= 0 || L <= 0) return 0;
  const cudaError_t bad =
      check_args(batch, heads, kv_heads, L, d, causal, window);
  if (bad != cudaSuccess) return (int)bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dim<float>(q, k, v, dout, lse, delta, dq, batch,
                                    heads, kv_heads, L, d, causal, window,
                                    scale, s);
  if (dtype == 1)
    return (int)dispatch_dim<__nv_bfloat16>(q, k, v, dout, lse, delta, dq,
                                            batch, heads, kv_heads, L, d,
                                            causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* cxxnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
