// Cross-channel LRN backward for NCHW tensors, fp32 and bf16, for sm_90a.
//
// Replaces the TPU kernel _lrn_bwd_kernel (cxxnet_tpu/ops/pallas_kernels.py:60,
// launched by _lrn_bwd_call at :98). For x of shape (B, C, H, W), the f32
// norm that the forward kernel saved (lrn_fwd.cu) and the upstream gradient
// g, both of x's shape:
//
//   dx[m] = g[m] * n[m]^(-beta)
//           - 2 * salpha * beta * x[m] * sum_{i : m in win(i)} g[i] x[i] n[i]^(-beta-1)
//
// at every (b, h, w), with win(i) = [i - lo, i - lo + nsize), lo = nsize/2,
// and salpha = alpha / nsize. The channels i whose window holds m form the
// mirrored window [m + lo - nsize + 1, m + lo], clipped to [0, C); for even
// nsize it is not win(m). The arithmetic is f32 whatever the input dtype and
// dx is cast back to it.
//
// Design. The TPU kernel forms the mirrored sum as a transposed C x C band
// matmul on the MXU. Here one thread owns one (b, h*w) position and walks
// the C channels, keeping the mirrored window's sum of
// t[i] = g[i] x[i] n[i]^(-beta-1) in a register: each step adds the channel
// that enters the window and subtracts the one that leaves, so the work is
// O(C) per pixel. The running sum is kept in double, so that
// add-then-subtract over 256 channels does not drift; t itself is an f32
// product, as in the plain version. n^(-beta) is computed once per channel
// visit with powf and n^(-beta-1) is taken as n^(-beta) / n. Consecutive
// threads own consecutive h*w positions, so every channel step is a
// coalesced warp access.
//
// Bound. The function reads x, norm (f32) and g once and writes dx once:
// B*C*H*W * (3*sizeof(T) + 4) bytes over the card's 3.35 TB/s (H100 SXM):
// 16 B per element in fp32, e.g. 17.9 M elements * 16 B = 287 MB -> 86 us
// for AlexNet's lrn1 at batch 256. The kernel reads each channel's x, g and
// norm three times (as the channel enters the window, as it leaves it, and
// for its own dx); the re-reads come about nsize/2 channel steps apart and
// hit L1/L2. Its operations (a powf, a divide and about ten multiply-adds per
// visit) are far below the fp32 rate, so bytes bound it. Vectorised loads,
// channel tiles staged in shared memory, and more threads per pixel where
// B*H*W is small (lrn2: 43k threads for 132 SMs) are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// t[i] = g[i] * x[i] * n[i]^(-beta-1) at the channel offset `off`
template <typename T>
__device__ __forceinline__ float window_term(const T* xp, const float* np_,
                                             const T* gp, int64_t off,
                                             float beta) {
  const float n = np_[off];
  return load_f32(gp + off) * load_f32(xp + off) * (powf(n, -beta) / n);
}

template <typename T>
__global__ void lrn_bwd_kernel(const T* __restrict__ x,
                               const float* __restrict__ norm,
                               const T* __restrict__ g, T* __restrict__ dx,
                               int64_t n_pos, int channels, int64_t hw,
                               int nsize, float coef, float beta) {
  const int64_t pos = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pos >= n_pos) return;
  const int64_t b = pos / hw;
  const int64_t offset = b * channels * hw + (pos - b * hw);
  const T* xp = x + offset;
  const float* np_ = norm + offset;
  const T* gp = g + offset;
  T* dp = dx + offset;
  const int lo = nsize / 2;

  // mirrored window of channel 0: [0, min(lo, C - 1)]
  double s = 0.0;
  const int first_hi = min(lo, channels - 1);
  for (int i = 0; i <= first_hi; ++i)
    s += (double)window_term(xp, np_, gp, (int64_t)i * hw, beta);
  for (int m = 0; m < channels; ++m) {
    if (m > 0) {
      const int enter = m + lo;
      if (enter < channels)
        s += (double)window_term(xp, np_, gp, (int64_t)enter * hw, beta);
      const int leave = m + lo - nsize;
      if (leave >= 0)
        s -= (double)window_term(xp, np_, gp, (int64_t)leave * hw, beta);
    }
    const int64_t off = (int64_t)m * hw;
    const float gm = load_f32(gp + off);
    const float xm = load_f32(xp + off);
    const float pm = powf(np_[off], -beta);
    store_from_f32(dp + off, gm * pm - coef * xm * (float)s);
  }
}

constexpr int kThreads = 128;

template <typename T>
cudaError_t launch(const void* x, const float* norm, const void* g, void* dx,
                   int64_t batch, int channels, int64_t hw, int nsize,
                   float coef, float beta, cudaStream_t stream) {
  const int64_t n_pos = batch * hw;
  const int64_t blocks = (n_pos + kThreads - 1) / kThreads;
  lrn_bwd_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), norm, static_cast<const T*>(g),
      static_cast<T*>(dx), n_pos, channels, hw, nsize, coef, beta);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, g and dx; norm is always float32).
// coef = 2 * (alpha / nsize) * beta. Returns the cudaError_t of the launch
// (0 = success). Launches on `stream` and does not synchronise.
int cxxnet_lrn_bwd(const void* x, const float* norm, const void* g, void* dx,
                   int dtype, long long batch, int channels, long long hw,
                   int nsize, float coef, float beta, void* stream) {
  if (batch <= 0 || hw <= 0 || channels <= 0) return 0;
  if (nsize < 1) return (int)cudaErrorInvalidValue;
  if ((batch * hw + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, norm, g, dx, batch, channels, hw, nsize,
                              coef, beta, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, norm, g, dx, batch, channels, hw,
                                      nsize, coef, beta, s);
  return (int)cudaErrorInvalidValue;
}

const char* cxxnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
