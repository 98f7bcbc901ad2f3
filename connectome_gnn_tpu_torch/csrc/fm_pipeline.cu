// Feature-major band-pipeline probes B3 for NVIDIA Hopper (built for sm_90a):
// one kernel body over an int8 band with an S-stage cp.async ring in shared
// memory, instantiated per body, activation type, layout and depth.
//
// Replaces the Pallas TPU kernels of benchmarks/fm_kernel_diag.py:
//   B3a _fm_pipeline     (pallas_call at :130), reached by
//       fm_dma_only  :157  copy-plus-add body           <kDmaOnly, bf16, FM, 2>
//                          (and S > 2, a probe of the staging rate the TPU had not)
//       fm_w8a8      :545  int8 band x int8 x dots      <kDots, int8, FM, 2>
//       (fm_bf16_band :271, the bf16 band's dots, is role B of band_mma.cu)
//   B3b fm_compute_only  (pallas_call at :242)          <kComputeOnly, bf16, FM, 2>
//   B3c fm_deep          (pallas_call at :393)          <kDots, bf16, FM, S>
//   B3d fm_blocked       (pallas_call at :495)          <kDots, bf16, Blocked, S>
// with S in {2, 3, 4, 6, 8}, the depths the script sweeps.
//
// Math.  The band holds, for row block rb and diagonal d in [0, 2W], one
// transposed b x b int8 tile, tileT[s, r] = A[r, s], with one f32 scale.
// The activations are the W-shifted padded frame: feature-major
// x[f, blk*b + s] (ldx its row stride) or blocked x[(blk*F + f)*b + s], blk
// in [0, nb + 2W), bf16 or int8 with one f32 scale per block.  kDots computes
//
//   out[f, rb*b + r] = sum_d scale(rb, d) * sum_s x[f, (rb + d)*b + s] * tileT[rb, d][s, r]
//
// with scale(rb, d) = scales[rb, d] (times xscales[rb + d] for int8 x).  Every
// int8 by bf16 product is exact in f32 and each tile's dot is summed
// in f32 (int8 x: exactly in int32 by __dp4a, as K5), so the only difference
// from the plain version is the order of the f32 sums; fm_w8a8 is K5's
// function bit for bit.  kDmaOnly writes out[f, rb*b + c] = x[f, rb*b + c] +
// tileT[rb, 0][f, c] for f < F <= b (the padded frame, not shifted back), after
// staging every byte of every tile and every x window.  kComputeOnly stages
// only panel 0 (band rows 0..R-1, x window 0) and computes every chunk i of R
// row blocks with the loop-variant indices rr = (r + i) mod R and
// kk = (r + d + i) mod (R + 2W):
//
//   acc_i[f, r*b + c] = sum_d scales[(i*R + r)*D + d] * sum_s x[f, kk*b + s] * tileT[rr, d][s, c]
//
// and writes only chunk i* (the largest even i < nb / R; the TPU kernel's
// slots alternate and its final copy reads slot 0), as out[f, r*b + c].
//
// What bounds it on this card.  At the 1M-node shape (nb = 4096, b = 256,
// W = 2, F = 64) the dots bodies multiply every entry of the dense tiles, 86 G
// multiply-adds, on the CUDA cores (67 TFLOP/s f32; __dp4a does four int8
// products an instruction): at best about 2.6 ms, above the 0.4 ms that the
// band's 1.34 GB take at 3.35 TB/s.  The products the data needs (39.8M
// nonzeros) take far less, so the least time
// of each function is its bytes.  The two probes do more work than their
// output needs, by design, so their times are rates, not shares of a bound:
//   * kDmaOnly's output needs only rows 0..F-1 of diagonal 0's tiles (67 MB
//     of the band) besides x, a bound of about 0.18 ms; it stages every
//     byte of the band and each x block once per diagonal and 64-receiver
//     tile, about 4.0 GB, so its time is the ring's staging rate.
//   * kComputeOnly's output is chunk i*'s panel, one chunk's dots; it
//     computes every chunk, reading panel 0 again each time: 10.5 MB of int8
//     band and a 1.2 MB x window, far above an SM's 228 KB of shared memory
//     (the TPU kept it resident in VMEM) but well inside the 50 MB L2, so on
//     this card the compute-only floor is "compute plus staging from L2",
//     not pure compute.
//
// What the design does about it.
//   * One thread block per (chunk of R row blocks, 64-receiver tile,
//     64-feature slice).  It walks the chunk's row blocks in order, and for
//     each its D tiles in steps of 32 senders: R * D * ceil(b / 32) stages,
//     one pipeline across the chunk, as the TPU kernel's panel.  So R sets
//     the number of thread blocks and the length of each one's pipeline;
//     every output's sum runs over d, then the senders, whatever R is.
//   * The S-stage ring: each stage holds 32 senders x 64 receivers of raw
//     band bytes and 64 features x 32 senders of raw activation bytes, copied
//     by cp.async.cg.shared.global of 16 bytes (the counterpart of
//     make_async_copy), a commit group per stream and cp.async.wait_group
//     <(S-2) groups of stages> before use (the DMA semaphores).  S - 1 stages
//     are in flight while one is consumed.  The bytes are widened where they
//     are used, not while they are staged.  Above 48 KB (S = 8 with int8
//     band and bf16 x) the launch raises the block's dynamic shared-memory
//     limit.
//   * band_splits K (fm_deep) maps to K commit groups per stage, each over
//     1/K of the stage's 32 band rows, where the TPU kernel started K DMAs.
//     On this card the copies are the same 16-byte cp.async instructions
//     either way and all of a stage's are in flight together; K changes only
//     how many groups the wait counts.  K is 1, 2 or 4.
//   * Dead code: cp.async is never eliminated, so kDmaOnly's unused tile
//     bytes are really staged.  kComputeOnly folds the accumulators of every
//     chunk other than i* into one sink float (a warp sum and an atomic add
//     per row block), so no chunk's arithmetic can be dropped.
//   * Each thread keeps a 4 x 4 register tile of receivers x features;
//     neighbouring threads take neighbouring receivers, the contiguous axis
//     of the feature-major and blocked output.  Receivers, senders and
//     features past b or F are zero-filled by the copy (src-size 0) and
//     masked at the store.  b must be a multiple of 16, so a 16-byte copy
//     never straddles a row's end.  All offsets are 64-bit.
//
// Each C entry point returns cudaGetLastError() after its launch (or
// cudaErrorInvalidValue for arguments it does not take), as an int; 0 is
// success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 64;  // receivers per thread block
constexpr int kTileN = 64;  // features per thread block
constexpr int kTileK = 32;  // senders per stage
constexpr int kMicro = 4;   // each thread: kMicro receivers x kMicro features
constexpr int kGroups = kTileM / kMicro;
constexpr int kRowPad = 16;  // bytes after each staged row: rows stay 16-byte aligned

static_assert(kGroups * (kTileN / kMicro) == kThreads, "one 4x4 tile per thread");

enum class Body { kDots, kDmaOnly, kComputeOnly };
enum class Layout { kFeatureMajor, kBlocked };

struct Params {
  const void* band;
  const float* scales;
  const void* x;
  const float* xscales;
  float* out;
  float* sink;
  int W, b, F, R, K, i_star;
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

// Stage t has landed once at most the S - 2 later stages' groups (K band
// groups and one x group each) are pending.
template <int S>
__device__ __forceinline__ void wait_stage(int K) {
  if (K == 1) {
    cp_async_wait<(S - 2) * 2>();
  } else if (K == 2) {
    cp_async_wait<(S - 2) * 3>();
  } else {
    cp_async_wait<(S - 2) * 5>();
  }
}

__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// Four consecutive staged int8 band entries (receivers c..c+3 of one sender row), widened.
__device__ __forceinline__ void load4(const unsigned char* row, int c, float (&v)[kMicro]) {
  const char4 w = *reinterpret_cast<const char4*>(row + c);
  v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
}

template <typename T>
__device__ __forceinline__ float widen_at(const unsigned char* row, int i) {
  if constexpr (std::is_same_v<T, int8_t>) {
    return (float)reinterpret_cast<const int8_t*>(row)[i];
  } else {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[i]);
  }
}

template <Body kBody, typename XT, Layout kLayout, int S>
__global__ void __launch_bounds__(kThreads) fm_pipeline_kernel(const Params p) {
  constexpr bool kInt8X = std::is_same_v<XT, int8_t>;
  static_assert(!kInt8X || (kBody == Body::kDots && kLayout == Layout::kFeatureMajor),
                "int8 activations take the dots body and feature-major x");
  constexpr int kBandRow = kTileM + kRowPad;  // bytes of an int8 band row
  constexpr int kXRow = kTileK * (int)sizeof(XT) + kRowPad;
  constexpr int kBandStage = kTileK * kBandRow;
  constexpr int kStage = kBandStage + kTileN * kXRow;
  constexpr int kBandChunks = kTileM / 16;  // 16-byte copies a band row
  constexpr int kXChunks = kTileK * (int)sizeof(XT) / 16;        // 16-byte copies an x row
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = p.b, F = p.F, R = p.R, K = p.K;
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
  const int8_t* band = static_cast<const int8_t*>(p.band);
  const XT* x = static_cast<const XT*>(p.x);

  auto commit_empty = [&]() {
    for (int g = 0; g <= K; ++g) cp_async_commit();
  };
  // Stage t into slot t % S: K groups of band rows, then one group of x.
  auto issue = [&](int t) {
    unsigned char* sb = smem + (t % S) * kStage;
    unsigned char* sx = sb + kBandStage;
    const int r = t / per_row, d = (t / nK) % D, s0 = (t % nK) * kTileK;
    long long tile_id, blk;
    if constexpr (kBody == Body::kComputeOnly) {
      tile_id = (long long)((r + chunk) % R) * D + d;
      blk = (r + d + chunk) % (R + 2 * p.W);
    } else {
      const long long rb = (long long)chunk * R + r;
      tile_id = rb * D + d;
      blk = rb + d;
    }
    const int8_t* tile = band + (size_t)tile_id * b * b;
    const int rows = kTileK / K;
    for (int g = 0; g < K; ++g) {
      for (int idx = tid; idx < rows * kBandChunks; idx += kThreads) {
        const int k = g * rows + idx / kBandChunks;
        const int c = (idx % kBandChunks) * 16;
        const bool ok = s0 + k < b && m0 + c < b;
        const int8_t* src = ok ? tile + (size_t)(s0 + k) * b + m0 + c : tile;
        cp_async16(sb + k * kBandRow + c, src, ok);
      }
      cp_async_commit();
    }
    for (int idx = tid; idx < kTileN * kXChunks; idx += kThreads) {
      const int f = idx / kXChunks;
      const int c = (idx % kXChunks) * (16 / (int)sizeof(XT));
      const bool ok = f0 + f < F && s0 + c < b;
      const XT* src = x;
      if (ok) {
        if constexpr (kLayout == Layout::kBlocked) {
          src = x + ((size_t)blk * F + f0 + f) * b + s0 + c;
        } else {
          src = x + (size_t)(f0 + f) * p.ldx + (size_t)blk * b + s0 + c;
        }
      }
      cp_async16(sx + f * kXRow + c * (int)sizeof(XT), src, ok);
    }
    cp_async_commit();
  };

  for (int t = 0; t < S - 1; ++t) {
    if (t < T) {
      issue(t);
    } else {
      commit_empty();
    }
  }

  using Dot = std::conditional_t<kInt8X, int, float>;
  float acc[kMicro][kMicro] = {};
  Dot dot[kMicro][kMicro] = {};
  for (int t = 0; t < T; ++t) {
    wait_stage<S>(K);
    // every thread is past stage t - 1, whose slot the next issue refills
    __syncthreads();
    if (t + S - 1 < T) {
      issue(t + S - 1);
    } else {
      commit_empty();
    }
    const unsigned char* sb = smem + (t % S) * kStage;
    const unsigned char* sx = sb + kBandStage;
    const int r = t / per_row, d = (t / nK) % D, s0 = (t % nK) * kTileK;

    if constexpr (kBody == Body::kDmaOnly) {
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
              acc[i][j] += widen_at<XT>(sx + (tn * kMicro + j) * kXRow, c - s0);
            if (f >= s0 && f < s0 + kTileK)
              acc[i][j] += widen_at<int8_t>(sb + (f - s0) * kBandRow, tm * kMicro + i);
          }
        }
      }
    } else if constexpr (kInt8X) {
#pragma unroll
      for (int k0 = 0; k0 < kTileK; k0 += 4) {
        // four sender rows of four receivers, transposed to four senders a receiver
        unsigned a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          a[q] = *reinterpret_cast<const unsigned*>(sb + (k0 + q) * kBandRow + tm * kMicro);
        const unsigned lo01 = __byte_perm(a[0], a[1], 0x5140), hi01 = __byte_perm(a[0], a[1], 0x7362);
        const unsigned lo23 = __byte_perm(a[2], a[3], 0x5140), hi23 = __byte_perm(a[2], a[3], 0x7362);
        const int w[kMicro] = {(int)__byte_perm(lo01, lo23, 0x5410), (int)__byte_perm(lo01, lo23, 0x7632),
                               (int)__byte_perm(hi01, hi23, 0x5410), (int)__byte_perm(hi01, hi23, 0x7632)};
        int xw[kMicro];
#pragma unroll
        for (int j = 0; j < kMicro; ++j)
          xw[j] = *reinterpret_cast<const int*>(sx + (tn * kMicro + j) * kXRow + k0);
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j) dot[i][j] = __dp4a(w[i], xw[j], dot[i][j]);
      }
    } else {
#pragma unroll
      for (int k0 = 0; k0 < kTileK; k0 += 8) {
        float xv[kMicro][8];
#pragma unroll
        for (int j = 0; j < kMicro; ++j) {
          const uint4 w = *reinterpret_cast<const uint4*>(sx + (tn * kMicro + j) * kXRow + 2 * k0);
          xv[j][0] = bf16_lo(w.x), xv[j][1] = bf16_hi(w.x), xv[j][2] = bf16_lo(w.y);
          xv[j][3] = bf16_hi(w.y), xv[j][4] = bf16_lo(w.z), xv[j][5] = bf16_hi(w.z);
          xv[j][6] = bf16_lo(w.w), xv[j][7] = bf16_hi(w.w);
        }
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          float av[kMicro];
          load4(sb + (k0 + kk) * kBandRow, tm * kMicro, av);
#pragma unroll
          for (int i = 0; i < kMicro; ++i)
#pragma unroll
            for (int j = 0; j < kMicro; ++j) dot[i][j] = fmaf(av[i], xv[j][kk], dot[i][j]);
        }
      }
    }

    if constexpr (kBody != Body::kDmaOnly) {
      if (t % nK == nK - 1) {  // the tile's last senders: scale its dot into the sum
        const long long rb = (long long)chunk * R + r;
        float scale = p.scales[(size_t)rb * D + d];
        if constexpr (kInt8X) scale = scale * p.xscales[rb + d];
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j) {
            acc[i][j] += scale * (float)dot[i][j];
            dot[i][j] = 0;
          }
      }
    }

    if (t % per_row == per_row - 1) {  // the row block's last stage: store it
      if (kBody == Body::kComputeOnly && chunk != p.i_star) {
        float v = 0.f;
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j) v += acc[i][j];
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if ((tid & 31) == 0) atomicAdd(p.sink, v);
      } else {
        // compute-only writes chunk i*'s panel at its local row r
        const long long rb = kBody == Body::kComputeOnly ? r : (long long)chunk * R + r;
#pragma unroll
        for (int i = 0; i < kMicro; ++i) {
          const int c = m0 + tm * kMicro + i;
          if (c >= b) continue;
#pragma unroll
          for (int j = 0; j < kMicro; ++j) {
            const int f = f0 + tn * kMicro + j;
            if (f >= F) continue;
            if constexpr (kLayout == Layout::kBlocked) {
              p.out[((size_t)rb * F + f) * b + c] = acc[i][j];
            } else {
              p.out[(size_t)f * p.ldo + (size_t)rb * b + c] = acc[i][j];
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;
    }
  }
}

bool valid(int nb, int W, int b, int F, int R, int K) {
  return nb > 0 && W >= 0 && b > 0 && b % 16 == 0 && F > 0 && R > 0 && nb % R == 0 &&
         (K == 1 || K == 2 || K == 4);
}

template <Body kBody, typename XT, Layout kLayout, int S>
int launch(const Params& p, int chunks, void* stream) {
  static_assert(S >= 2, "a ring of at least two stages");
  constexpr int kStage = kTileK * (kTileM + kRowPad) +
                         kTileN * (kTileK * (int)sizeof(XT) + kRowPad);
  constexpr int kSmem = S * kStage;
  const long long blocks =
      (long long)chunks * ((p.b + kTileM - 1) / kTileM) * ((p.F + kTileN - 1) / kTileN);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = fm_pipeline_kernel<kBody, XT, kLayout, S>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, kSmem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// An int8 band and bf16 x at depth S in {2, 3, 4, 6, 8}.
template <Body kBody, Layout kLayout>
int launch_int8_depth(int S, const Params& p, int chunks, void* stream) {
  switch (S) {
    case 2: return launch<kBody, __nv_bfloat16, kLayout, 2>(p, chunks, stream);
    case 3: return launch<kBody, __nv_bfloat16, kLayout, 3>(p, chunks, stream);
    case 4: return launch<kBody, __nv_bfloat16, kLayout, 4>(p, chunks, stream);
    case 6: return launch<kBody, __nv_bfloat16, kLayout, 6>(p, chunks, stream);
    case 8: return launch<kBody, __nv_bfloat16, kLayout, 8>(p, chunks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

Params params(const void* band, const float* scales, const void* x, const float* xscales,
              float* out, float* sink, int W, int b, int F, int R, int K, long long ldx,
              long long ldo) {
  return Params{band, scales, x, xscales, out, sink, W, b, F, R, K, -1, ldx, ldo};
}

}  // namespace

extern "C" {

// B3c: x_pad [F, (nb + 2W) * block] bf16 with row stride ldx; outT [F, nb * block].
int cgt_fm_deep(const int8_t* band_qT, const float* scales, const __nv_bfloat16* x_pad,
                float* outT, int nb, int W, int block, int F, int R, int depth, int band_splits,
                long long ldx, void* stream) {
  if (!valid(nb, W, block, F, R, band_splits)) return (int)cudaErrorInvalidValue;
  const Params p = params(band_qT, scales, x_pad, nullptr, outT, nullptr, W, block, F, R,
                          band_splits, ldx, (long long)nb * block);
  return launch_int8_depth<Body::kDots, Layout::kFeatureMajor>(depth, p, nb / R, stream);
}

// B3d: xb [nb + 2W, F, block] bf16; out [nb, F, block].
int cgt_fm_blocked(const int8_t* band_qT, const float* scales, const __nv_bfloat16* xb,
                   float* out, int nb, int W, int block, int F, int R, int depth, void* stream) {
  if (!valid(nb, W, block, F, R, 1)) return (int)cudaErrorInvalidValue;
  const Params p = params(band_qT, scales, xb, nullptr, out, nullptr, W, block, F, R, 1, 0, 0);
  return launch_int8_depth<Body::kDots, Layout::kBlocked>(depth, p, nb / R, stream);
}

// B3a, fm_w8a8: xq [F, (nb + 2W) * block] int8 with one scale per block.
int cgt_fm_w8a8(const int8_t* band_qT, const float* scales, const int8_t* xq,
                const float* xscales, float* outT, int nb, int W, int block, int F, int R,
                long long ldx, void* stream) {
  if (!valid(nb, W, block, F, R, 1)) return (int)cudaErrorInvalidValue;
  const Params p = params(band_qT, scales, xq, xscales, outT, nullptr, W, block, F, R, 1, ldx,
                          (long long)nb * block);
  return launch<Body::kDots, int8_t, Layout::kFeatureMajor, 2>(p, nb / R, stream);
}

// B3a, fm_dma_only: outT [F, nb * block] = x_pad + tile (rb, 0) rows 0..F-1.
// The TPU kernel is 2-deep; other depths probe the staging rate.
int cgt_fm_dma_only(const int8_t* band_qT, const __nv_bfloat16* x_pad, float* outT, int nb,
                    int W, int block, int F, int R, int depth, long long ldx, void* stream) {
  if (!valid(nb, W, block, F, R, 1) || F > block) return (int)cudaErrorInvalidValue;
  const Params p = params(band_qT, nullptr, x_pad, nullptr, outT, nullptr, W, block, F, R, 1, ldx,
                          (long long)nb * block);
  return launch_int8_depth<Body::kDmaOnly, Layout::kFeatureMajor>(depth, p, nb / R, stream);
}

// B3b: x_win [F, (R + 2W) * block] bf16 (window 0 of the padded frame);
// out [F, R * block], chunk i*'s panel; sink one float, zeroed by the caller.
int cgt_fm_compute_only(const int8_t* band_qT, const float* scales, const __nv_bfloat16* x_win,
                        float* out, float* sink, int nb, int W, int block, int F, int R,
                        long long ldx, void* stream) {
  if (!valid(nb, W, block, F, R, 1)) return (int)cudaErrorInvalidValue;
  Params p = params(band_qT, scales, x_win, nullptr, out, sink, W, block, F, R, 1, ldx,
                    (long long)R * block);
  p.i_star = (nb / R - 1) / 2 * 2;
  return launch<Body::kComputeOnly, __nv_bfloat16, Layout::kFeatureMajor, 2>(p, nb / R,
                                                                                     stream);
}

}  // extern "C"
