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
// Bound. The function reads x, norm (f32) and g once and writes dx once:
// B*C*H*W * (3*sizeof(T) + 4) bytes over the card's 3.35 TB/s (H100 SXM),
// 16 B an element in fp32. Its operations (a powf, nsize adds and six
// multiplies an element) stay under the fp32 rate, so bytes bound it.
//
// Design, as lrn_fwd.cu's. A block of kThreads threads owns kThreads
// consecutive (b, h*w) positions and a tile of kChannelTile channels (a 1-D
// grid of ceil(B*H*W / kThreads) * ceil(C / kChannelTile) blocks, the tile
// varying fastest). Each thread owns one position and stages x, g and the
// norm of its column of the tile with the mirrored halo, rows
// [c0 + lo - nsize + 1, c0 + kChannelTile + lo), into shared memory with
// 4-byte cp.async copies (lrn_tile.cuh; rows outside [0, C) zero-filled by
// the copy and given t = 0). Then, once a staged
// element, q = n^(-beta-1) with the one powf and t = (g * x) * q, as the
// plain version forms it; for the tile's own channels p = n^(-beta) as
// q * n, a multiply and no divide, within an ulp or two of powf(n, -beta)
// (a second powf an element ran slower on the card). Each mirrored
// window of t is summed directly, in f32, in ascending channel order (the
// plain version's order), and dx = (g * p) - ((coef * x) * s) with
// __fmul_rn / __fsub_rn, no FMA contraction. Each value is read from HBM
// about once; the halo's re-read of (nsize - 1) / kChannelTile hits L2. Only
// the thread reads its column, so the block never synchronises; stores are
// coalesced along the positions.
//
// Resources (nvcc -Xptxas -v, printed by chip_smoke.py): 40 registers and no
// spills, fp32 and bf16 (PERF.md, kernel table row 2). Shared memory is
// dynamic: 12 bytes a staged element, (kChannelTile + nsize - 1) * kThreads
// * 12 bytes a block, 30 KB at nsize 5.

#include "lrn_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lrn_bwd_kernel(const T* __restrict__ x, const float* __restrict__ norm,
                   const T* __restrict__ g, T* __restrict__ dx,
                   int64_t n_pos, int channels, int64_t hw, int nsize,
                   float coef, float beta) {
  extern __shared__ uint32_t smem[];
  const int rows = kChannelTile + nsize - 1;
  // this thread's column: rows of x, g (raw words) and norm; after the
  // second pass t in the norm's rows, and for the tile's own channels
  // coef * x and g * p (as f32) in the x and g rows
  uint32_t* xs = smem + threadIdx.x;
  uint32_t* gs = xs + rows * kThreads;
  uint32_t* ns = gs + rows * kThreads;
  // the channel tile varies fastest along the grid, so the tiles that
  // share a halo run together and its re-read hits L2
  const int n_tiles = (channels + kChannelTile - 1) / kChannelTile;
  const int64_t pos =
      (int64_t)(blockIdx.x / n_tiles) * kThreads + threadIdx.x;
  if (pos >= n_pos) return;
  const int64_t b = pos / hw;
  const int64_t base = b * channels * hw + (pos - b * hw);  // (b, 0, p)
  const T* xb = x + base;
  const T* gb = g + base;
  const int lo = nsize / 2;
  const int c0 = (int)(blockIdx.x % n_tiles) * kChannelTile;
  const int first = c0 + lo - nsize + 1;  // the channel of row 0
  const int own_row = nsize - 1 - lo;     // the row of channel c0
  const int own = min(kChannelTile, channels - c0);

  for (int r = 0; r < rows; ++r) {
    const int c = first + r;
    const bool in = c >= 0 && c < channels;
    const int64_t off = (int64_t)(in ? c : 0) * hw;
    const int bytes = in ? 4 : 0;
    cp_async_word(xs + r * kThreads, word_of(xb + off), bytes);
    cp_async_word(gs + r * kThreads, word_of(gb + off), bytes);
    cp_async_word(ns + r * kThreads, norm + base + off, bytes);
  }
  cp_async_wait_all();
  const float nb1 = -beta - 1.0f;
  for (int r = 0; r < rows; ++r) {
    const int c = first + r;
    if (c < 0 || c >= channels) {
      ns[r * kThreads] = 0u;  // t = +0: the plain version's padding
      continue;
    }
    const int64_t off = (int64_t)c * hw;
    const float xv = from_word(xs[r * kThreads], xb + off);
    const float gv = from_word(gs[r * kThreads], gb + off);
    const float n = __uint_as_float(ns[r * kThreads]);
    const float q = powf(n, nb1);  // n^(-beta-1)
    ns[r * kThreads] = __float_as_uint(__fmul_rn(__fmul_rn(gv, xv), q));
    if (r >= own_row && r < own_row + own) {
      xs[r * kThreads] = __float_as_uint(__fmul_rn(coef, xv));
      // p = n^(-beta) as n^(-beta-1) * n
      gs[r * kThreads] = __float_as_uint(__fmul_rn(gv, __fmul_rn(q, n)));
    }
  }

  // the mirrored window of channel c0 + i is rows i .. i + nsize - 1
  const float* t = reinterpret_cast<const float*>(ns);
  float s[kChannelTile];
#pragma unroll
  for (int i = 0; i < kChannelTile; ++i) s[i] = t[i * kThreads];
  for (int j = 1; j < nsize; ++j) {
#pragma unroll
    for (int i = 0; i < kChannelTile; ++i)
      s[i] = __fadd_rn(s[i], t[(i + j) * kThreads]);
  }

#pragma unroll
  for (int i = 0; i < kChannelTile; ++i) {
    if (i < own) {
      const int r = (i + own_row) * kThreads;
      const float gp = __uint_as_float(gs[r]);
      const float cx = __uint_as_float(xs[r]);
      store_from_f32(dx + base + (int64_t)(c0 + i) * hw,
                     __fsub_rn(gp, __fmul_rn(cx, s[i])));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* norm, const void* g, void* dx,
                   int64_t batch, int channels, int64_t hw, int nsize,
                   float coef, float beta, cudaStream_t stream) {
  const int64_t n_pos = batch * hw;
  const size_t smem =
      (size_t)(kChannelTile + nsize - 1) * kThreads * 3 * sizeof(uint32_t);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lrn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (n_pos + kThreads - 1) / kThreads *
                        ((channels + kChannelTile - 1) / kChannelTile);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  lrn_bwd_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
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
