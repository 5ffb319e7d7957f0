// Flash attention backward, dK and dV, for (b, h, L, d) tensors, fp32 and
// bf16, for sm_90a.
//
// Replaces the TPU kernel _dkv_kernel (cxxnet_tpu/ops/flash_attn.py:156,
// launched by _flash_bwd at :363). With P = exp(scale q k^T + mask - lse)
// recomputed from the forward's lse, dP = dO v^T and D = rowsum(dO o)
// (computed before the launch), each key row of (batch, kv head) gets
//
//   dv = sum over its query heads of P^T dO
//   dk = sum over its query heads of scale * (P o (dP - D))^T q
//
// with the forward's mask. Every sum is f32 whatever the input dtype; dk
// and dv are stored in the input dtype, at kv-head resolution.
//
// Design. One block owns 64 keys of one (batch, kv head). It stages K^T
// and V^T once (transposed, so that a thread's 8 key rows are two float4
// loads) and loops over the h / nkv query heads that share the kv head and,
// for each, over the q tiles that _block_needed keeps: from the tile that
// holds the kv tile's diagonal to the end, clipped by the window (the
// forward's loop read the other way). Per q tile it stages Q and dO
// (row-major, rows padded to D + 1 words) and the tile's lse and D,
// computes S^T and dP^T for the thread's 8 keys x NC queries in one pass
// over the head dim, forms P and dS, writes both transposed to shared
// memory, and accumulates dV += P^T dO and dK += dS^T Q in registers
// (8 keys x D / TX columns each). dK and dV are written once. Departure
// from the JAX package, on purpose: it writes dK/dV per query head and
// sums the group outside (:353-357, :384-385); the loop over the group
// inside the block needs no h / nkv-times buffer, no reduction afterwards
// and no atomics, so a backward is bitwise repeatable. Query rows at or
// past L contribute exactly nothing: their p is set to 0 and their lse is
// never read (JAX gets this from zero-padded dO). A masked pair gets p = 0
// outright, so exp never sees NEG_INF. Head dim 128 runs 256 threads (32
// column lanes) so that dK and dV stay at 2 x 8 x 4 registers. Head dim 256
// gives a block 32 keys (4 row groups) and 64 column lanes, again 256
// threads and 2 x 8 x 4 accumulator registers: at 64 keys its K^T, V^T,
// Q, dO, P^T and dS^T tiles would take 299 KB of shared memory, over the
// 227 KB a block may opt into; at 32 they take 219 KB.
//
// Bound. 8 d flops per (query, key) pair the mask keeps (S, dV, dP, dK),
// at 67 TFLOP/s fp32: for the bench.py LM's step (b 8, h 8, L 2048, d 64,
// causal) 134 M pairs, 68.7 GFLOP -> 1.03 ms; the bytes (0.2 GB, 0.06 ms)
// are far below it. The S/dP pass issues 12 shared loads per 64 FMAs per
// thread, the dV/dK pass 4 + 2 D/TX per 16 D/TX, plus an exp per score
// and three barriers per q tile.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
struct Tiles {
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

template <typename T, int D, bool kExact>
__global__ void __launch_bounds__(Tiles<D>::kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int heads, int group, int64_t L,
                     int d_in, int causal, int64_t window, float scale) {
  // the row stride; the compiled width itself when d is one of them
  const int d = kExact ? D : d_in;
  using C = Tiles<D>;
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
  const int64_t bkv = blockIdx.x;  // batch * kv_heads + kv head
  const int kv_heads = heads / group;
  const int64_t batch = bkv / kv_heads, kvh = bkv % kv_heads;
  const int64_t k0 = (int64_t)blockIdx.y * BK;
  const T* kp = k + bkv * L * d;
  const T* vp = v + bkv * L * d;

  for (int idx = tid; idx < BK * D; idx += C::kThreads) {
    const int r = idx / D, c = idx % D;
    kt[c * kPadKey + r] = load_or_zero<kExact>(kp, k0 + r, L, c, d);
    vt[c * kPadKey + r] = load_or_zero<kExact>(vp, k0 + r, L, c, d);
  }
  float acc_k[kRows][NA], acc_v[kRows][NA];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < NA; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  int64_t q_begin, q_end;
  q_tiles_for_kv<kBQ, BK>(k0, L, causal, window, &q_begin, &q_end);

  for (int g = 0; g < group; ++g) {
    const int64_t bh = batch * heads + kvh * group + g;
    const T* qp = q + bh * L * d;
    const T* dop = dout + bh * L * d;
    for (int64_t t = q_begin; t < q_end; ++t) {
      const int64_t q0 = t * kBQ;
      __syncthreads();  // K, V are in; the last tile's readers are done
      for (int idx = tid; idx < kBQ * D; idx += C::kThreads) {
        const int r = idx / D, c = idx % D;
        qs[r * kPadD + c] = load_or_zero<kExact>(qp, q0 + r, L, c, d);
        dos[r * kPadD + c] = load_or_zero<kExact>(dop, q0 + r, L, c, d);
      }
      for (int r = tid; r < kBQ; r += C::kThreads) {
        const int64_t qpos = q0 + r;
        lse_s[r] = qpos < L ? lse[bh * L + qpos] : 0.f;
        d_s[r] = qpos < L ? delta[bh * L + qpos] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for the thread's 8 keys x NC queries
      float s[kRows][NC], dp[kRows][NC];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int jj = 0; jj < NC; ++jj) s[i][jj] = dp[i][jj] = 0.f;
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

      // P and dS = P (dP - D) scale, written transposed: [query][key]
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) {
        const int qc = tx + TX * jj;
        const int64_t qpos = q0 + qc;
        const float lse_q = lse_s[qc], d_q = d_s[qc];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p =
              (qpos < L && keep(qpos, k0 + ty * 8 + i, L, causal, window))
                  ? expf(s[i][jj] * scale - lse_q)
                  : 0.f;
          pt[qc * kPadKey + ty * 8 + i] = p;
          dst[qc * kPadKey + ty * 8 + i] = p * (dp[i][jj] - d_q) * scale;
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q
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
    if (kpos < L) {
      T* kout = dk + (bkv * L + kpos) * d;
      T* vout = dv + (bkv * L + kpos) * d;
#pragma unroll
      for (int c = 0; c < NA; ++c) {
        if (kExact || tx + TX * c < d) {
          store_from_f32(kout + tx + TX * c, acc_k[i][c]);
          store_from_f32(vout + tx + TX * c, acc_v[i][c]);
        }
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int64_t batch, int heads, int kv_heads,
                   int64_t L, int d, int causal, int64_t window, float scale,
                   cudaStream_t stream) {
  using C = Tiles<D>;
  // a head dim equal to the compiled width takes the instantiation with
  // compile-time strides and no column checks
  const auto kernel = d == D ? flash_bwd_dkv_kernel<T, D, true>
                              : flash_bwd_dkv_kernel<T, D, false>;
  // above 48 KB a block's dynamic shared memory must be allowed first
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::smem);
  if (err != cudaSuccess) return err;
  // kv tile 0 first: under a causal mask it feeds the most q tiles
  const dim3 grid((unsigned)(batch * kv_heads),
                  (unsigned)((L + C::BK - 1) / C::BK));
  kernel<<<grid, C::kThreads, C::smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), heads, heads / kv_heads, L,
      d, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv,
                         int64_t batch, int heads, int kv_heads, int64_t L,
                         int d, int causal, int64_t window, float scale,
                         cudaStream_t s) {
  switch (compiled_width(d)) {
    case 16:
      return launch<T, 16>(q, k, v, dout, lse, delta, dk, dv, batch, heads,
                           kv_heads, L, d, causal, window, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, delta, dk, dv, batch, heads,
                           kv_heads, L, d, causal, window, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dk, dv, batch, heads,
                           kv_heads, L, d, causal, window, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dk, dv, batch, heads,
                            kv_heads, L, d, causal, window, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, dout, lse, delta, dk, dv, batch, heads,
                            kv_heads, L, d, causal, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dk, dv); 1 <= d <= 256;
// kv_heads divides heads; window > 0 only with causal. q, dout (batch,
// heads, L, d), k, v, dk, dv (batch, kv_heads, L, d), lse and delta (batch,
// heads, L) f32, all contiguous. Returns the cudaError_t of the launch
// (0 = success). Launches on `stream` and does not synchronise.
int cxxnet_flash_bwd_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int dtype,
                         long long batch, int heads, int kv_heads,
                         long long L, int d, int causal, long long window,
                         float scale, void* stream) {
  if (batch <= 0 || L <= 0) return 0;
  const cudaError_t bad =
      check_args(batch, heads, kv_heads, L, d, causal, window);
  if (bad != cudaSuccess) return (int)bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dim<float>(q, k, v, dout, lse, delta, dk, dv, batch,
                                    heads, kv_heads, L, d, causal, window,
                                    scale, s);
  if (dtype == 1)
    return (int)dispatch_dim<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv,
                                            batch, heads, kv_heads, L, d,
                                            causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* cxxnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
