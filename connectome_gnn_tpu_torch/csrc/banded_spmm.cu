// Band SpMM kernel B2b on int8 activations for NVIDIA Hopper (built for
// sm_90a): a kernel body on the CUDA cores over the int8 band, row-major.
// K3-K7, B2a and B2c run on the tensor-core body in band_mma.cu; K5, B2b's
// function on feature-major activations, runs there on s8 x s8 products.
//
// Replaces the Pallas TPU kernel
//   in benchmarks/quant_kernel_diag.py:
//   B2b banded_spmm_w8a8             (pallas_call at :173)  K5's math on
//       row-major int8 activations and receiver-major tiles
//
// Math.  The band holds, for row block rb and diagonal d in [0, 2W], one
// b x b int8 tile with one f32 scale.  With A[r, s] the tile's weight of the
// edge from sender s of block rb + d - W to receiver r of block rb, and
// X[s, f] that sender's activation:
//
//   out[rb*b + r, f] = sum_d scale[rb, d] * sum_s A[r, s] * X[s, f]
//
// B2b reads receiver-major tiles (A[r, s] at tile[r*b + s]) and node-major
// int8 x already quantized per node block in the W-shifted padded frame
// (block rb + d is sender block rb + d - W; the halo blocks are zero), takes
// each tile's dot exactly in int32 with __dp4a, and applies
// (scale[rb, d] * xscale[rb + d]) * float(dot).
//
// What bounds it on this card.  At the 1M-node shape (NB = 4096, b = 256,
// W = 2, F = 64) the kernel multiplies every entry of the dense tiles, 86 G
// multiply-adds, against a band of 1.34 GB, four multiply-adds a __dp4a.
// Only 39.8M of the 1.34G tile entries are nonzero (3.0 %), so the
// function's least time is the bytes it moves (the band, x and out): about
// 0.56 ms.  Tensor cores move a band kernel towards that bound, as
// band_mma.cu does for K5 with wgmma's s8 x s8 form; moving B2b there is
// later work.
//
// What the design does about it.
//   * One thread block per (row block, 64-receiver tile, 64-feature slice),
//     so a million-node pass launches 16,384 blocks; nothing passes between
//     blocks.  The TPU kernel's sequential grid, panel size and manual DMA
//     pipeline have no counterpart.
//   * The contraction over senders is staged 32 at a time in shared
//     memory, packed four senders per 32-bit word, so any block size b and
//     any F >= 1 work; receivers past b or num_nodes and features past F are
//     masked.
//   * Each thread keeps a 4 x 4 register tile of receivers x features,
//     one per-tile int32 dot and one f32 sum over d.  Neighbouring threads
//     take neighbouring features, the contiguous axis of the node-major
//     output, so the stores are coalesced.
//   * All offsets into the band and the activations are 64-bit: the band
//     has 1.34e9 entries at the 1M-node shape.
//
// The C entry point returns cudaGetLastError() after its launch, as an int;
// 0 is success.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 64;  // receivers per thread block
constexpr int kTileN = 64;  // features per thread block
constexpr int kTileK = 32;  // senders staged per step
constexpr int kRows = kTileK / 4;  // staged words: four int8 senders each
constexpr int kMicro = 4;   // each thread: kMicro receivers x kMicro features
constexpr int kGroups = kTileM / kMicro;  // 16 receiver groups, 16 feature groups
constexpr int kPad = 4;     // row padding in shared memory; keeps 16-byte alignment

static_assert(kGroups * (kTileN / kMicro) == kThreads, "one 4x4 tile per thread");

__global__ void __launch_bounds__(kThreads) band_spmm_kernel(
    const int8_t* __restrict__ band, const float* __restrict__ scales,
    const int8_t* __restrict__ xq, const float* __restrict__ xscales,
    float* __restrict__ out, int W, int b, int F, int n, long long ldx) {
  __shared__ __align__(16) int As[kRows][kTileM + kPad];  // As[k][m] = A[m0+m, s0+4k .. 4k+3]
  __shared__ __align__(16) int Xs[kRows][kTileN + kPad];  // Xs[k][f] = X[s0+4k .. 4k+3, f0+f]

  const int D = 2 * W + 1;
  const int mtiles = (b + kTileM - 1) / kTileM;
  const int rb = blockIdx.x / mtiles;
  const int m0 = (blockIdx.x % mtiles) * kTileM;
  const int f0 = blockIdx.y * kTileN;
  const int tid = threadIdx.x;
  // neighbouring threads take neighbouring features, neighbouring output addresses
  const int tm = tid / kGroups, tn = tid % kGroups;

  float acc[kMicro][kMicro] = {};
  for (int d = 0; d < D; ++d) {
    const int8_t* tile = band + (((size_t)rb * D + d) * b) * b;
    // first sender of the window: a row of the padded frame
    const long long first = (long long)(rb + d) * b;
    int dot[kMicro][kMicro] = {};
    for (int s0 = 0; s0 < b; s0 += kTileK) {
      for (int idx = tid; idx < kTileM * kRows; idx += kThreads) {
        // read along the tile's contiguous axis: four senders a thread
        const int m = idx / kRows, k4 = idx % kRows;
        const int r = m0 + m;
        unsigned word = 0;
        for (int j = 0; j < 4; ++j) {
          const int s = s0 + 4 * k4 + j;
          int v = 0;
          if (r < b && s < b) v = tile[(size_t)r * b + s];
          word |= (unsigned)(v & 0xff) << (8 * j);
        }
        As[k4][m] = (int)word;
      }
      for (int idx = tid; idx < kTileN * kRows; idx += kThreads) {
        // row-major x: four senders of one feature at stride ldx
        const int k4 = idx / kTileN, f = idx % kTileN;
        unsigned word = 0;
        for (int j = 0; j < 4; ++j) {
          const int s = s0 + 4 * k4 + j;
          int v = 0;
          if (f0 + f < F && s < b) v = xq[(first + s) * ldx + f0 + f];
          word |= (unsigned)(v & 0xff) << (8 * j);
        }
        Xs[k4][f] = (int)word;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kRows; ++k) {
        const int4 a = *reinterpret_cast<const int4*>(&As[k][tm * kMicro]);
        const int4 v = *reinterpret_cast<const int4*>(&Xs[k][tn * kMicro]);
        const int av[kMicro] = {a.x, a.y, a.z, a.w};
        const int xv[kMicro] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j) dot[i][j] = __dp4a(av[i], xv[j], dot[i][j]);
      }
      __syncthreads();
    }
    const float scale = scales[(size_t)rb * D + d] * xscales[rb + d];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) acc[i][j] += scale * (float)dot[i][j];
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int r = m0 + tm * kMicro + i;
    const long long node = (long long)rb * b + r;
    if (r >= b || node >= n) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int f = f0 + tn * kMicro + j;
      if (f < F) out[node * F + f] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// B2b: receiver-major int8 tiles, xq [(nb + 2W) * block, F] int8 in the
// W-shifted padded frame with one scale per block, ldx its row stride.
int cgt_banded_spmm_w8a8_rowmajor(const int8_t* band_q, const float* scales, const int8_t* xq,
                                  const float* xscales, float* out, int nb, int W, int block,
                                  int F, int num_nodes, long long ldx, void* stream) {
  if (nb <= 0 || W < 0 || block <= 0 || F <= 0 || num_nodes <= 0 || num_nodes > (long long)nb * block)
    return (int)cudaErrorInvalidValue;
  const long long mtiles = (block + kTileM - 1) / kTileM;
  const dim3 grid((unsigned)(nb * mtiles), (unsigned)((F + kTileN - 1) / kTileN));
  band_spmm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(band_q, scales, xq, xscales, out, W, block,
                                                                F, num_nodes, ldx);
  return (int)cudaGetLastError();
}

}  // extern "C"
