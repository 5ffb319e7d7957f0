// Uniform random numbers in [0, 1) from Philox4x32-10, float32, for sm_90a.
// Two entry points: cxxnet_uniform, one flat stream per seed (below), and
// cxxnet_uniform_rows, one stream per row of a sampling step (at the end).
//
// Replaces the TPU kernel _uniform_kernel (cxxnet_tpu/ops/pallas_kernels.py
// :138, launched by uniform at :169), the draw behind rrelu_mask (:180):
// the insanity layer's random slopes and the insanity pooling's
// displacement flags. For n elements and a 64-bit seed it writes
//
//   out[i] = (word i % 4 of Philox4x32-10((i / 4 lo, i / 4 hi, 0, 0),
//                                        (seed lo, seed hi)) >> 8) * 2^-24
//
// the TPU kernel's 24-bit ladder, on a stream that depends on (seed, i)
// alone, so that the plain version (ops/random.py uniform_ref) gives the
// same bits on the card and on the CPU.
//
// Design. The TPU kernel reseeds its on-core generator per block of rows,
// prng_seed(seed, block), so that every tile draws its own stream; a
// counter-based generator needs no state at all: the counter is the flat
// index over 4, so any thread may compute any block, and the grid, the
// block size and the elements per thread never change the stream. One
// thread takes one counter (10 rounds of two 32 x 32 -> 64-bit products and
// four xors, the key bumped by the Weyl constants between rounds) and
// stores its 4 outputs as one float4, so that a warp writes 512
// consecutive bytes; a grid-stride loop with a 64-bit index covers any n,
// and the last counter, when n % 4 != 0, stores its first n % 4 words one
// by one.
//
// Bound. The kernel reads nothing and writes 4 bytes per element: n * 4 /
// 3.35 TB/s, 0.089 ms for conv1's draw in AlexNet training (256 x 96 x 55 x
// 55 = 74.3 M elements). The ~110 integer operations per counter (~28 per
// element) are 2 G operations there, below that time at the card's scalar
// rate, so the stores bound it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // round multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // key increments
constexpr int kRounds = 10;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 8192;  // grid-stride beyond this

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t lo0 = kM0 * c.x, hi0 = __umulhi(kM0, c.x);
    const uint32_t lo1 = kM1 * c.z, hi1 = __umulhi(kM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// the top 24 bits as a float in [0, 1): exact, 2^24 values
__device__ __forceinline__ float to_unit(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

__global__ void __launch_bounds__(kThreads)
uniform_kernel(float* __restrict__ out, int64_t n, uint32_t k0, uint32_t k1) {
  const int64_t n_ctr = (n + 3) / 4, n_full = n / 4;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n_ctr;
       i += stride) {
    const uint4 r = philox4x32_10(
        make_uint4((uint32_t)i, (uint32_t)(i >> 32), 0u, 0u), k0, k1);
    if (i < n_full) {
      reinterpret_cast<float4*>(out)[i] =
          make_float4(to_unit(r.x), to_unit(r.y), to_unit(r.z), to_unit(r.w));
    } else {
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
      for (int64_t j = 0; j < n - 4 * i; ++j) out[4 * i + j] = to_unit(w[j]);
    }
  }
}

// The per-row draw of a sampling step (Trainer.generate with temperature >
// 0, DecodeSession.step): element j of row r is
//
//   out[r, j] = (word j % 4 of Philox4x32-10((j / 4, pos[r], rowid[r], 0),
//                                            (seed[r] lo, seed[r] hi))
//                >> 8) * 2^-24
//
// so that a row's draw depends on its request's seed, its position and its
// row within the request alone, never on the slot it occupies or on the
// other rows of the batch: the draw of a session's slot is the draw of the
// same request run alone (ops/random.py uniform_rows_ref, bit for bit).
// It replaces no TPU kernel: the JAX package draws its sampling noise with
// jax.random.categorical (cxxnet_tpu/nnet/trainer.py:45-71, _sample_pick),
// whose bits cannot be reproduced here, so the port samples by Gumbel-max
// over this draw, with the same kernel body as the flat stream.
//
// Design: blockIdx.y is the row, each thread one counter of it (four
// elements), a grid-stride loop over the counters of the row; a row whose
// width is a multiple of 4 (every vocabulary the port serves) stores one
// float4 per counter, any other width element by element. The row's seed,
// position and row id are read once per thread from device arrays, so a
// session step launches with no host-to-device copy.
//
// Bound: nothing to read but 3 words a row; 4 bytes written per element:
// rows * n * 4 / 3.35 TB/s, 0.078 us for 8 rows of the bench.py LM's
// vocabulary of 8192, far under the launch itself.
constexpr int64_t kMaxRowBlocks = 64;

__global__ void __launch_bounds__(kThreads)
uniform_rows_kernel(float* __restrict__ out, int64_t n,
                    const int64_t* __restrict__ seeds,
                    const int64_t* __restrict__ pos,
                    const int64_t* __restrict__ rowid) {
  const int64_t r = blockIdx.y;
  const uint64_t seed = (uint64_t)seeds[r];
  const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  const uint32_t c1 = (uint32_t)pos[r], c2 = (uint32_t)rowid[r];
  float* row = out + r * n;
  const int64_t n_ctr = (n + 3) / 4, n_full = n / 4;
  const bool vec = (n % 4) == 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n_ctr;
       i += stride) {
    const uint4 w = philox4x32_10(make_uint4((uint32_t)i, c1, c2, 0u), k0, k1);
    if (vec) {
      reinterpret_cast<float4*>(row)[i] =
          make_float4(to_unit(w.x), to_unit(w.y), to_unit(w.z), to_unit(w.w));
    } else {
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
      const int64_t m = i < n_full ? 4 : n - 4 * i;
      for (int64_t j = 0; j < m; ++j) row[4 * i + j] = to_unit(ws[j]);
    }
  }
}

}  // namespace

extern "C" {

// out: n float32, 16-byte aligned (a fresh torch.empty is). key0, key1: the
// seed's low and high words. Returns the cudaError_t of the launch (0 =
// success). Launches on `stream` and does not synchronise.
int cxxnet_uniform(float* out, long long n, uint32_t key0, uint32_t key1,
                   void* stream) {
  if (n <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int64_t n_ctr = (n + 3) / 4;
  int64_t blocks = (n_ctr + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  uniform_kernel<<<(unsigned)blocks, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(out, n, key0, key1);
  return (int)cudaGetLastError();
}

// out: rows x n float32, 16-byte aligned. seeds, pos, rowid: rows int64
// each on the device (a seed's 64 bits as two's complement). Returns the
// cudaError_t of the launch (0 = success). Launches on `stream` and does
// not synchronise.
int cxxnet_uniform_rows(float* out, long long rows, long long n,
                        const int64_t* seeds, const int64_t* pos,
                        const int64_t* rowid, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int64_t n_ctr = (n + 3) / 4;
  int64_t blocks = (n_ctr + kThreads - 1) / kThreads;
  if (blocks > kMaxRowBlocks) blocks = kMaxRowBlocks;
  uniform_rows_kernel<<<dim3((unsigned)blocks, (unsigned)rows), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(out, n, seeds,
                                                             pos, rowid);
  return (int)cudaGetLastError();
}

const char* cxxnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
