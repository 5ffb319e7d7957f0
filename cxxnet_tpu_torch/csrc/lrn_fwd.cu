// Cross-channel LRN forward for NCHW tensors, fp32 and bf16, for sm_90a.
//
// Replaces the TPU kernel _lrn_fwd_kernel (cxxnet_tpu/ops/pallas_kernels.py:49,
// launched by _lrn_call at :78). For x of shape (B, C, H, W):
//
//   norm[b,i,p] = knorm + salpha * sum_{j in win(i)} x[b,j,p]^2
//   out[b,i,p]  = x[b,i,p] * norm[b,i,p]^(-beta)
//
// with win(i) = [i - nsize/2, i - nsize/2 + nsize) clipped to [0, C) (the
// reference's mshadow chpool window) and salpha = alpha / nsize. The
// arithmetic is f32 whatever the input dtype; out is cast back to the input
// dtype and norm is written in f32 (the backward kernel reads it). With
// norm == NULL (inference) no norm is stored.
//
// Bound. The function reads x once and writes out (and norm) once:
// B*C*H*W * (2*sizeof(T) + 4) bytes with the norm, 2*sizeof(T) without it,
// over the card's 3.35 TB/s (H100 SXM): 12 B an element in fp32 for
// training, 8 B for inference. Its operations (a square, nsize adds, a
// powf and three multiply-adds an element) stay under the fp32 rate, so
// bytes bound it.
//
// Design. The TPU kernel forms the window sum as a C x C band matmul on the
// MXU. Here a block of kThreads threads owns kThreads consecutive (b, h*w)
// positions and a tile of kChannelTile output channels: a 1-D grid of
// ceil(B*H*W / kThreads) * ceil(C / kChannelTile) blocks, the tile varying
// fastest, so the tiles that share a halo run together; even AlexNet's lrn2
// (13 x 13 planes) fills every SM many times over. Each thread owns one
// position and stages its column of the tile with the halo, rows
// [c0 - nsize/2, c0 + kChannelTile + nsize - 1 - nsize/2), into shared
// memory with cp.async: all the rows' copies are in flight at once,
// consecutive threads copy consecutive addresses (coalesced), and rows
// outside [0, C) are zero-filled by the copy itself. A channel row's stride
// (H*W elements) need not be a multiple of 16 bytes, so the copies are of
// the 4-byte word that holds the element (lrn_tile.cuh; a bf16 element is
// picked out of its word); each value is read from HBM about once, the
// halo's re-read of
// (nsize - 1) / kChannelTile hits L2. Only the thread reads its column, so
// the block never synchronises. x^2 is computed once a staged value, and
// each window is summed directly, in f32, in ascending channel order,
// from shared memory: __fmul_rn / __fadd_rn, no FMA contraction, and the
// norm as (s * salpha) + knorm. That is the plain version's order of
// operations (ops/lrn.py _window_sum: its padded zeros add exactly), so the
// norm is bitwise the plain version's on the card. Stores are coalesced
// along the positions. The tile is 16 channels: on the card it ran faster
// than 8, 32 or 64 (more blocks an SM than at 32, fewer registers). The
// accurate powf is most of the instructions of the no-norm forward.
//
// Resources (nvcc -Xptxas -v, printed by chip_smoke.py): 40 registers and no
// spills, fp32 and bf16 (PERF.md, kernel table row 1). Shared memory is
// dynamic: 8 bytes a staged element, (kChannelTile + nsize - 1) * kThreads
// * 8 bytes a block, 20 KB at nsize 5.

#include "lrn_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ out,
                   float* __restrict__ norm, int64_t n_pos, int channels,
                   int64_t hw, int nsize, float salpha, float beta,
                   float knorm) {
  extern __shared__ uint32_t smem[];
  const int rows = kChannelTile + nsize - 1;
  // this thread's column: rows of raw words, then rows of squares
  uint32_t* xs = smem + threadIdx.x;
  float* sq = reinterpret_cast<float*>(smem + rows * kThreads) + threadIdx.x;
  // the channel tile varies fastest along the grid, so the tiles that
  // share a halo run together and its re-read hits L2
  const int n_tiles = (channels + kChannelTile - 1) / kChannelTile;
  const int64_t pos =
      (int64_t)(blockIdx.x / n_tiles) * kThreads + threadIdx.x;
  if (pos >= n_pos) return;
  const int64_t b = pos / hw;
  const int64_t base = b * channels * hw + (pos - b * hw);  // (b, 0, p)
  const T* xb = x + base;
  const int lo = nsize / 2;
  const int c0 = (int)(blockIdx.x % n_tiles) * kChannelTile;
  const int first = c0 - lo;  // the channel of row 0

  for (int r = 0; r < rows; ++r) {
    const int c = first + r;
    const bool in = c >= 0 && c < channels;
    cp_async_word(xs + r * kThreads, word_of(xb + (in ? c : 0) * hw),
                  in ? 4 : 0);
  }
  cp_async_wait_all();
  for (int r = 0; r < rows; ++r) {
    const int c = min(max(first + r, 0), channels - 1);
    const float v = from_word(xs[r * kThreads], xb + c * hw);
    sq[r * kThreads] = __fmul_rn(v, v);
  }

  // the window of output channel c0 + i is rows i .. i + nsize - 1
  float s[kChannelTile];
#pragma unroll
  for (int i = 0; i < kChannelTile; ++i) s[i] = sq[i * kThreads];
  for (int j = 1; j < nsize; ++j) {
#pragma unroll
    for (int i = 0; i < kChannelTile; ++i)
      s[i] = __fadd_rn(s[i], sq[(i + j) * kThreads]);
  }

  const int own = min(kChannelTile, channels - c0);
#pragma unroll
  for (int i = 0; i < kChannelTile; ++i) {
    if (i < own) {
      const int64_t off = (int64_t)(c0 + i) * hw;
      const float n = __fadd_rn(__fmul_rn(s[i], salpha), knorm);
      if (norm != nullptr) norm[base + off] = n;
      const float xi = from_word(xs[(i + lo) * kThreads], xb + off);
      store_from_f32(out + base + off, __fmul_rn(xi, powf(n, -beta)));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, float* norm, int64_t batch,
                   int channels, int64_t hw, int nsize, float salpha,
                   float beta, float knorm, cudaStream_t stream) {
  const int64_t n_pos = batch * hw;
  const size_t smem =
      (size_t)(kChannelTile + nsize - 1) * kThreads * 2 * sizeof(uint32_t);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lrn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (n_pos + kThreads - 1) / kThreads *
                        ((channels + kChannelTile - 1) / kChannelTile);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  lrn_fwd_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), norm, n_pos, channels,
      hw, nsize, salpha, beta, knorm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. norm may be NULL: then no norm is
// stored. Returns the cudaError_t of the launch (0 = success). Launches on
// `stream` and does not synchronise.
int cxxnet_lrn_fwd(const void* x, void* out, float* norm, int dtype,
                   long long batch, int channels, long long hw, int nsize,
                   float salpha, float beta, float knorm, void* stream) {
  if (batch <= 0 || hw <= 0 || channels <= 0) return 0;
  if (nsize < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, out, norm, batch, channels, hw, nsize,
                              salpha, beta, knorm, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, out, norm, batch, channels, hw,
                                      nsize, salpha, beta, knorm, s);
  return (int)cudaErrorInvalidValue;
}

const char* cxxnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
