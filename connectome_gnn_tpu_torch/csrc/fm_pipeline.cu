// The feature-major band-pipeline probe B3a dma-only for NVIDIA Hopper
// (built for sm_90a): a kernel body over an int8 band with a two-stage
// cp.async ring in shared memory.
//
// Replaces the Pallas TPU kernel of benchmarks/fm_kernel_diag.py:
//   B3a _fm_pipeline     (pallas_call at :130), reached by
//       fm_dma_only  :157  copy-plus-add body
//       (fm_bf16_band :271, the bf16 band's dots, is role B of band_mma.cu,
//       and fm_w8a8 :545, K5's function on given operands, K5's launch there)
// B3b fm_compute_only, B3c fm_deep and B3d fm_blocked are role B of
// band_mma.cu over the int8 band on a bf16 frame (B3b with its panel map).
//
// Math.  The band holds, for row block rb and diagonal d in [0, 2W], one
// transposed b x b int8 tile, tileT[s, r] = A[r, s].  The activations are
// the W-shifted padded frame, feature-major bf16 x[f, blk*b + s] (ldx its
// row stride), blk in [0, nb + 2W).  The probe writes out[f, rb*b + c] =
// x[f, rb*b + c] + tileT[rb, 0][f, c] for f < F <= b (the padded frame, not
// shifted back), after staging every byte of every tile and every x window.
//
// What bounds it on this card.  At the 1M-node shape (nb = 4096, b = 256,
// W = 2, F = 64) it does more work than its output needs, by design, so its
// time is a rate, not a share of a bound: its output needs only rows
// 0..F-1 of diagonal 0's tiles (67 MB of the band) besides x, a bound of
// about 0.18 ms; it stages every byte of the band and each x block once per
// diagonal and 64-receiver tile, about 4.0 GB, so its time is the ring's
// staging rate.
//
// What the design does about it.
//   * One thread block per (chunk of R row blocks, 64-receiver tile,
//     64-feature slice).  It walks the chunk's row blocks in order, and for
//     each its D tiles in steps of 32 senders: R * D * ceil(b / 32) stages,
//     one pipeline across the chunk, as the TPU kernel's panel.  So R sets
//     the number of thread blocks and the length of each one's pipeline;
//     every output's sum runs over d, then the senders, whatever R is.
//   * The two-stage ring, the TPU kernel's: each stage holds 32 senders x
//     64 receivers of raw band bytes and 64 features x 32 senders of raw
//     activation bytes, copied by cp.async.cg.shared.global of 16 bytes
//     (the counterpart of make_async_copy) in one commit group, and
//     cp.async.wait_group 0 before use (the DMA semaphores): the next
//     stage's copies are in flight while one is consumed.  The bytes are
//     widened where they are used, not while they are staged.
//   * Dead code: cp.async is never eliminated, so the unused tile bytes are
//     really staged.
//   * Each thread keeps a 4 x 4 register tile of receivers x features;
//     neighbouring threads take neighbouring receivers, the contiguous axis
//     of the feature-major output.  Receivers, senders and features past b
//     or F are zero-filled by the copy (src-size 0) and masked at the
//     store.  b must be a multiple of 16, so a 16-byte copy never straddles
//     a row's end.  All offsets are 64-bit.
//
// The C entry point returns cudaGetLastError() after its launch (or
// cudaErrorInvalidValue for arguments it does not take), as an int; 0 is
// success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 64;  // receivers per thread block
constexpr int kTileN = 64;  // features per thread block
constexpr int kTileK = 32;  // senders per stage
constexpr int kMicro = 4;   // each thread: kMicro receivers x kMicro features
constexpr int kGroups = kTileM / kMicro;
constexpr int kRowPad = 16;  // bytes after each staged row: rows stay 16-byte aligned
constexpr int kStages = 2;   // the ring's depth, the TPU kernel's

static_assert(kGroups * (kTileN / kMicro) == kThreads, "one 4x4 tile per thread");

struct Params {
  const int8_t* band;
  const __nv_bfloat16* x;
  float* out;
  int W, b, F, R;
  long long ldx;  // feature-major x: row stride in elements
  long long ldo;  // feature-major out: row stride in elements
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

using XT = __nv_bfloat16;
constexpr int kBandRow = kTileM + kRowPad;  // bytes of an int8 band row
constexpr int kXRow = kTileK * (int)sizeof(XT) + kRowPad;
constexpr int kBandStage = kTileK * kBandRow;
constexpr int kStage = kBandStage + kTileN * kXRow;
constexpr int kSmem = kStages * kStage;  // under the 48 KB a block has without opting in
static_assert(kSmem <= 48 * 1024, "the ring fits the default dynamic shared memory");

__global__ void __launch_bounds__(kThreads) fm_pipeline_kernel(const Params p) {
  constexpr int kBandChunks = kTileM / 16;  // 16-byte copies a band row
  constexpr int kXChunks = kTileK * (int)sizeof(XT) / 16;        // 16-byte copies an x row
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = p.b, F = p.F, R = p.R;
  const int D = 2 * p.W + 1;
  const int nK = (b + kTileK - 1) / kTileK;  // stages a tile
  const int per_row = D * nK;                // stages a row block
  const int T = R * per_row;                 // stages a thread block
  const int ftiles = (F + kTileN - 1) / kTileN;
  const int mtiles = (b + kTileM - 1) / kTileM;
  const int f0 = (int)(blockIdx.x % ftiles) * kTileN;
  const int m0 = (int)((blockIdx.x / ftiles) % mtiles) * kTileM;
  const int chunk = (int)(blockIdx.x / ftiles / mtiles);
  const int tid = threadIdx.x;
  const int tm = tid % kGroups, tn = tid / kGroups;
  const int8_t* band = p.band;
  const XT* x = p.x;

  // Stage t into slot t % kStages, band rows and x in one commit group.
  auto issue = [&](int t) {
    unsigned char* sb = smem + (t % kStages) * kStage;
    unsigned char* sx = sb + kBandStage;
    const int r = t / per_row, d = (t / nK) % D, s0 = (t % nK) * kTileK;
    const long long rb = (long long)chunk * R + r, blk = rb + d;
    const int8_t* tile = band + (size_t)(rb * D + d) * b * b;
    for (int idx = tid; idx < kTileK * kBandChunks; idx += kThreads) {
      const int k = idx / kBandChunks;
      const int c = (idx % kBandChunks) * 16;
      const bool ok = s0 + k < b && m0 + c < b;
      const int8_t* src = ok ? tile + (size_t)(s0 + k) * b + m0 + c : tile;
      cp_async16(sb + k * kBandRow + c, src, ok);
    }
    for (int idx = tid; idx < kTileN * kXChunks; idx += kThreads) {
      const int f = idx / kXChunks;
      const int c = (idx % kXChunks) * (16 / (int)sizeof(XT));
      const bool ok = f0 + f < F && s0 + c < b;
      const XT* src = ok ? x + (size_t)(f0 + f) * p.ldx + (size_t)blk * b + s0 + c : x;
      cp_async16(sx + f * kXRow + c * (int)sizeof(XT), src, ok);
    }
    cp_async_commit();
  };

  issue(0);

  float acc[kMicro][kMicro] = {};
  for (int t = 0; t < T; ++t) {
    cp_async_wait<0>();  // stage t has landed
    // every thread is past stage t - 1, whose slot the next issue refills
    __syncthreads();
    if (t + 1 < T) issue(t + 1);
    const unsigned char* sb = smem + (t % kStages) * kStage;
    const unsigned char* sx = sb + kBandStage;
    const int r = t / per_row, d = (t / nK) % D, s0 = (t % nK) * kTileK;
    const long long rb = (long long)chunk * R + r;

    // out = x[f, rb*b + c] + tileT[rb, 0][f, c]: x from window block rb
    // (d = 0) at sender c, the band from sender row f; 0 + a + b is a + b
    if (d == 0) {
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
        const int c = m0 + tm * kMicro + i;
#pragma unroll
        for (int j = 0; j < kMicro; ++j) {
          const int f = f0 + tn * kMicro + j;
          if (c >= s0 && c < s0 + kTileK)
            acc[i][j] += __bfloat162float(reinterpret_cast<const XT*>(sx + (tn * kMicro + j) * kXRow)[c - s0]);
          if (f >= s0 && f < s0 + kTileK)
            acc[i][j] += (float)reinterpret_cast<const int8_t*>(sb + (f - s0) * kBandRow)[tm * kMicro + i];
        }
      }
    }

    if (t % per_row == per_row - 1) {  // the row block's last stage: store it
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
        const int c = m0 + tm * kMicro + i;
        if (c >= b) continue;
#pragma unroll
        for (int j = 0; j < kMicro; ++j) {
          const int f = f0 + tn * kMicro + j;
          if (f >= F) continue;
          p.out[(size_t)f * p.ldo + (size_t)rb * b + c] = acc[i][j];
        }
      }
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;
    }
  }
}

bool valid(int nb, int W, int b, int F, int R) {
  return nb > 0 && W >= 0 && b > 0 && b % 16 == 0 && F > 0 && R > 0 && nb % R == 0;
}

}  // namespace

extern "C" {

// B3a, fm_dma_only: outT [F, nb * block] = x_pad + tile (rb, 0) rows 0..F-1.
int cgt_fm_dma_only(const int8_t* band_qT, const __nv_bfloat16* x_pad, float* outT, int nb,
                    int W, int block, int F, int R, long long ldx, void* stream) {
  if (!valid(nb, W, block, F, R) || F > block) return (int)cudaErrorInvalidValue;
  const Params p{band_qT, x_pad, outT, W, block, F, R, ldx, (long long)nb * block};
  const long long blocks =
      (long long)(nb / R) * ((block + kTileM - 1) / kTileM) * ((F + kTileN - 1) / kTileN);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fm_pipeline_kernel<<<(unsigned)blocks, kThreads, kSmem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
