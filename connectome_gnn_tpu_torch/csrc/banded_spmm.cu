// Band SpMM kernels K3-K6, K7 over a float32 band, B2b and B2c for NVIDIA
// Hopper (built for sm_90a): one kernel body, instantiated per layout, band
// type and scale placement.  K7 over a bfloat16 band and B2a are role A of
// the tensor-core body in band_mma.cu.
//
// Replaces the Pallas TPU kernels
//   in connectome_gnn_tpu/ops/banded_quant.py:
//   K3  banded_spmm_quant          (pallas_call at :820)  row-major x [N, F]
//   K4  banded_spmm_quant_fm       (pallas_call at :284)  feature-major xT [F, N];
//       also the backward of banded_spmm_quant_fm_grad (:743), launched over
//       the transposed band
//   K5  banded_spmm_quant_fm_w8a8  (pallas_call at :434)  K4 on int8 activations
//   K6  banded_spmm_quant_blocked  (def at :480, pallas_call at :564)  K4 on
//       blocked activations [NB + 2W, F, b]; forward and backward of
//       banded_spmm_quant_blocked_grad (:639)
//   in connectome_gnn_tpu/ops/banded_pallas.py:
//   K7  banded_spmm_pallas         (pallas_call at :66)   over a f32 band, no
//       scales, row-major x as given
//   in benchmarks/quant_kernel_diag.py:
//   B2b banded_spmm_w8a8             (pallas_call at :173)  K5's math on
//       row-major int8 activations and receiver-major tiles
//   B2c banded_spmm_quant_fused_dot  (pallas_call at :250)  K3 with each
//       tile's scale folded into the tile, optionally rounded to bf16
//
// Math.  The band holds, for row block rb and diagonal d in [0, 2W], one
// b x b tile: int8 with one f32 scale (K3-K6, B2b, B2c), or f32 with none
// (K7).  With A[r, s] the tile's weight of the edge from
// sender s of block rb + d - W to receiver r of block rb, and X[s, f] that
// sender's activation:
//
//   out[rb*b + r, f] = sum_d scale[rb, d] * sum_s A[r, s] * X[s, f]
//
// K3, K7, B2b and B2c read receiver-major tiles (A[r, s] at tile[r*b + s]) and
// node-major x; K4, K5 and K6 read transposed tiles (A[r, s] at
// tile[s*b + r]).  K4 and K5 read feature-major activations and write
// feature-major output.  K6 reads blocked activations in the W-shifted
// padded frame, x[((rb + d) * F + f) * b + s], and writes
// out[(rb * F + f) * b + r]; it reads the whole frame, senders past
// num_nodes included, as the TPU kernel does.  K3, K4, K6 and B2c round x
// to bf16 (round to nearest even) and multiply in f32, where
// every int8 by bf16 product is exact; K7 multiplies f32 by f32
// with fmaf, never TF32.  B2c applies the scale to each tile entry as it is
// widened, scale * float(int8) in f32 (then rounded to bf16 with
// wrow_bf16), and sums the D tiles' products unscaled, as the TPU kernel's
// one wide dot does.  So, apart from K5 and B2b, the only difference from
// the plain version is the order of the f32 sums.  K5 and B2b read
// activations already quantized per node block in the W-shifted padded
// frame (block rb + d is sender block rb + d - W; the halo blocks are
// zero), take each tile's dot exactly in int32 with __dp4a, and apply
// (scale[rb, d] * xscale[rb + d]) * float(dot).
//
// What bounds it on this card.  At the 1M-node serving shape (NB = 4096,
// b = 256, W = 2, F = 64) the kernel multiplies every entry of the dense
// tiles, 86 G multiply-adds, against a band of 1.34 GB (int8) or 5.37 GB
// (f32).  On the CUDA cores (67 TFLOP/s f32) that takes about 2.6 ms at
// best, above the 0.4-1.6 ms the band's bytes take at 3.35 TB/s; the int8
// path does four multiply-adds per __dp4a.  Only 39.8M of the 1.34G tile
// entries are nonzero (3.0 %), so the products the function needs take
// about 0.08 ms even in exact f32, and its least time is the bytes it
// moves (the band, x and out): about 0.56 ms (int8) and 1.76 ms (f32).
// Tensor cores would move the int8 kernels towards that memory bound, as
// band_mma.cu does for the bf16 band; they are later work.  K6 does K4's
// arithmetic with other addresses, and is bound the same way: on the TPU the blocked layout
// turned strided DMA into contiguous slabs, but here both layouts already
// stage rows of 32 contiguous senders (128 bytes) and store rows of 64
// contiguous receivers, so K6 is one more instantiation of the same body,
// not a new one; so are K7-f32, B2b and B2c.
//
// What the design does about it.
//   * One thread block per (row block, 64-receiver tile, 64-feature slice),
//     so a million-node pass launches 16,384 blocks; nothing passes between
//     blocks.  The TPU kernels' sequential grid, panel size and manual DMA
//     pipeline have no counterpart.
//   * The contraction over senders is staged 32 at a time in shared
//     memory (17 KB a block, no dynamic shared memory at any b), widened
//     to f32 (scaled first in B2c) or packed four senders per 32-bit word
//     (K5, B2b), so any block size b and any F >= 1 work; receivers past b
//     or num_nodes, features past F and senders outside [0, num_nodes) are
//     masked.
//   * Each thread keeps a 4 x 4 register tile of receivers x features,
//     one per-tile dot (f32 or int32) and one sum over d.  Thread order
//     puts neighbouring threads on neighbouring output addresses in both
//     layouts, so the stores are coalesced.
//   * All offsets into the band and the activations are 64-bit: the band
//     has 1.34e9 entries at the 1M-node shape.
//
// Each C entry point returns cudaGetLastError() after its launch, as an
// int; 0 is success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 64;  // receivers per thread block
constexpr int kTileN = 64;  // features per thread block
constexpr int kTileK = 32;  // senders staged per step
constexpr int kMicro = 4;   // each thread: kMicro receivers x kMicro features
constexpr int kGroups = kTileM / kMicro;  // 16 receiver groups, 16 feature groups
constexpr int kPad = 4;     // row padding in shared memory; keeps 16-byte alignment

static_assert(kGroups * (kTileN / kMicro) == kThreads, "one 4x4 tile per thread");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float widen(int8_t v) { return (float)v; }
__device__ __forceinline__ float widen(float v) { return v; }

// K3, K7, B2b, B2c: kRowMajor.  K4, K5: kFeatureMajor.  K6: kBlocked.
enum class Layout { kRowMajor, kFeatureMajor, kBlocked };
// Where a tile's scale goes: none (float bands), on the tile's dot (K3-K6,
// B2b), or folded into the staged tile, as f32 or rounded to bf16 (B2c).
enum class Scale { kNone, kPerDot, kFolded, kFoldedBf16 };
// The activations: float32 as given (K7-f32), rounded to bf16 in staging,
// or int8 with one scale per block of the padded frame (K5, B2b).
enum class Act { kF32, kBf16, kInt8 };

template <Layout kLayout, typename BandT, Scale kScale, Act kAct>
__global__ void __launch_bounds__(kThreads) band_spmm_kernel(
    const BandT* __restrict__ band, const float* __restrict__ scales,
    const float* __restrict__ x, const int8_t* __restrict__ xq,
    const float* __restrict__ xscales, float* __restrict__ out, int W, int b,
    int F, int n, long long ldx) {
  constexpr bool kInt8Act = kAct == Act::kInt8;
  constexpr bool kRowMajor = kLayout == Layout::kRowMajor;
  constexpr bool kFolded = kScale == Scale::kFolded || kScale == Scale::kFoldedBf16;
  static_assert(!kInt8Act || (std::is_same_v<BandT, int8_t> && kScale == Scale::kPerDot &&
                              kLayout != Layout::kBlocked),
                "int8 activations take an int8 band, per-dot scales, row- or feature-major x");
  static_assert((kScale == Scale::kNone) != std::is_same_v<BandT, int8_t>,
                "an int8 band has per-tile scales, a float band none");
  using Elem = std::conditional_t<kInt8Act, int, float>;
  constexpr int kRows = kInt8Act ? kTileK / 4 : kTileK;  // int8 packs 4 senders a word
  __shared__ __align__(16) Elem As[kRows][kTileM + kPad];  // As[k][m] = A[m0+m, s0+k]
  __shared__ __align__(16) Elem Xs[kRows][kTileN + kPad];  // Xs[k][f] = X[s0+k, f0+f]

  const int D = 2 * W + 1;
  const int mtiles = (b + kTileM - 1) / kTileM;
  const int rb = blockIdx.x / mtiles;
  const int m0 = (blockIdx.x % mtiles) * kTileM;
  const int f0 = blockIdx.y * kTileN;
  const int tid = threadIdx.x;
  // neighbouring threads take neighbouring output addresses: features in
  // the node-major output, receivers in the feature-major and blocked ones
  const int tm = kRowMajor ? tid / kGroups : tid % kGroups;
  const int tn = kRowMajor ? tid % kGroups : tid / kGroups;

  float acc[kMicro][kMicro] = {};
  for (int d = 0; d < D; ++d) {
    const BandT* tile = band + (((size_t)rb * D + d) * b) * b;
    // first sender of the window: a node (float activations) or a row of
    // the padded frame (int8 activations)
    const long long first = kInt8Act ? (long long)(rb + d) * b : (long long)(rb + d - W) * b;
    float tile_scale = 1.f;
    if constexpr (kFolded) tile_scale = scales[(size_t)rb * D + d];
    Elem dot[kMicro][kMicro] = {};
    for (int s0 = 0; s0 < b; s0 += kTileK) {
      if constexpr (kInt8Act) {
        for (int idx = tid; idx < kTileM * kRows; idx += kThreads) {
          // read along the tile's contiguous axis: four senders a thread
          const int m = kRowMajor ? idx / kRows : idx % kTileM;
          const int k4 = kRowMajor ? idx % kRows : idx / kTileM;
          const int r = m0 + m;
          unsigned word = 0;
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + 4 * k4 + j;
            int v = 0;
            if (r < b && s < b) v = kRowMajor ? tile[(size_t)r * b + s] : tile[(size_t)s * b + r];
            word |= (unsigned)(v & 0xff) << (8 * j);
          }
          As[k4][m] = (int)word;
        }
        for (int idx = tid; idx < kTileN * kRows; idx += kThreads) {
          // row-major x: four senders of one feature at stride ldx
          const int k4 = kRowMajor ? idx / kTileN : idx % kRows;
          const int f = kRowMajor ? idx % kTileN : idx / kRows;
          unsigned word = 0;
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + 4 * k4 + j;
            int v = 0;
            if (f0 + f < F && s < b)
              v = kRowMajor ? xq[(first + s) * ldx + f0 + f] : xq[(size_t)(f0 + f) * ldx + first + s];
            word |= (unsigned)(v & 0xff) << (8 * j);
          }
          Xs[k4][f] = (int)word;
        }
      } else {
        for (int idx = tid; idx < kTileM * kTileK; idx += kThreads) {
          // read along the tile's contiguous axis
          const int m = kRowMajor ? idx / kTileK : idx % kTileM;
          const int k = kRowMajor ? idx % kTileK : idx / kTileM;
          const int r = m0 + m, s = s0 + k;
          float v = 0.f;
          if (r < b && s < b) {
            v = widen(kRowMajor ? tile[(size_t)r * b + s] : tile[(size_t)s * b + r]);
            if constexpr (kFolded) v = tile_scale * v;
            if constexpr (kScale == Scale::kFoldedBf16) v = round_bf16(v);
          }
          As[k][m] = v;
        }
        for (int idx = tid; idx < kTileN * kTileK; idx += kThreads) {
          const int f = kRowMajor ? idx % kTileN : idx / kTileK;
          const int k = kRowMajor ? idx / kTileN : idx % kTileK;
          const long long node = first + s0 + k;
          float v = 0.f;
          if constexpr (kLayout == Layout::kBlocked) {
            // window block rb + d of the padded frame; no sender mask
            if (f0 + f < F && s0 + k < b)
              v = x[((size_t)(rb + d) * F + f0 + f) * b + s0 + k];
          } else if (f0 + f < F && s0 + k < b && node >= 0 && node < n) {
            v = kRowMajor ? x[node * ldx + f0 + f] : x[(long long)(f0 + f) * ldx + node];
          }
          Xs[k][f] = kAct == Act::kBf16 ? round_bf16(v) : v;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kRows; ++k) {
        const auto a = *reinterpret_cast<const std::conditional_t<kInt8Act, int4, float4>*>(
            &As[k][tm * kMicro]);
        const auto v = *reinterpret_cast<const std::conditional_t<kInt8Act, int4, float4>*>(
            &Xs[k][tn * kMicro]);
        const Elem av[kMicro] = {a.x, a.y, a.z, a.w};
        const Elem xv[kMicro] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j) {
            if constexpr (kInt8Act) {
              dot[i][j] = __dp4a(av[i], xv[j], dot[i][j]);
            } else {
              dot[i][j] = fmaf(av[i], xv[j], dot[i][j]);
            }
          }
      }
      __syncthreads();
    }
    if constexpr (kScale == Scale::kPerDot) {
      float scale = scales[(size_t)rb * D + d];
      if constexpr (kInt8Act) scale = scale * xscales[rb + d];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] += scale * (float)dot[i][j];
    } else {
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] += dot[i][j];
    }
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int r = m0 + tm * kMicro + i;
    const long long node = (long long)rb * b + r;
    if (r >= b || node >= n) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int f = f0 + tn * kMicro + j;
      if (f >= F) continue;
      if constexpr (kRowMajor) {
        out[node * F + f] = acc[i][j];
      } else if constexpr (kLayout == Layout::kBlocked) {
        out[((size_t)rb * F + f) * b + r] = acc[i][j];
      } else {
        out[(long long)f * n + node] = acc[i][j];
      }
    }
  }
}

template <Layout kLayout, typename BandT, Scale kScale, Act kAct>
int launch(const BandT* band, const float* scales, const float* x, const int8_t* xq,
           const float* xscales, float* out, int nb, int W, int b, int F, int n,
           long long ldx, void* stream) {
  if (nb <= 0 || W < 0 || b <= 0 || F <= 0 || n <= 0 || n > (long long)nb * b)
    return (int)cudaErrorInvalidValue;
  const long long mtiles = (b + kTileM - 1) / kTileM;
  const dim3 grid((unsigned)(nb * mtiles), (unsigned)((F + kTileN - 1) / kTileN));
  band_spmm_kernel<kLayout, BandT, kScale, kAct><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      band, scales, x, xq, xscales, out, W, b, F, n, ldx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cgt_banded_spmm_quant(const int8_t* band_q, const float* scales, const float* x,
                          float* out, int nb, int W, int block, int F, int num_nodes,
                          long long ldx, void* stream) {
  return launch<Layout::kRowMajor, int8_t, Scale::kPerDot, Act::kBf16>(
      band_q, scales, x, nullptr, nullptr, out, nb, W, block, F, num_nodes, ldx, stream);
}

int cgt_banded_spmm_quant_fm(const int8_t* band_qT, const float* scales, const float* xT,
                             float* outT, int nb, int W, int block, int F, int num_nodes,
                             long long ldx, void* stream) {
  return launch<Layout::kFeatureMajor, int8_t, Scale::kPerDot, Act::kBf16>(
      band_qT, scales, xT, nullptr, nullptr, outT, nb, W, block, F, num_nodes, ldx, stream);
}

int cgt_banded_spmm_quant_fm_w8a8(const int8_t* band_qT, const float* scales,
                                  const int8_t* xq, const float* xscales, float* outT,
                                  int nb, int W, int block, int F, int num_nodes,
                                  long long ldx, void* stream) {
  return launch<Layout::kFeatureMajor, int8_t, Scale::kPerDot, Act::kInt8>(
      band_qT, scales, nullptr, xq, xscales, outT, nb, W, block, F, num_nodes, ldx, stream);
}

// xb_pad [nb + 2W, F, block] float32, out [nb, F, block]; every receiver of
// the frame is written, so num_nodes is the whole frame.
int cgt_banded_spmm_quant_blocked(const int8_t* band_qT, const float* scales,
                                  const float* xb_pad, float* out, int nb, int W, int block,
                                  int F, void* stream) {
  if (nb <= 0 || block <= 0 || (long long)nb * block > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return launch<Layout::kBlocked, int8_t, Scale::kPerDot, Act::kBf16>(
      band_qT, scales, xb_pad, nullptr, nullptr, out, nb, W, block, F, nb * block, F, stream);
}

// K7 with a float32 band: x as given, exact f32 products (no TF32).
int cgt_banded_spmm_direct_f32(const float* band, const float* x, float* out, int nb, int W,
                               int block, int F, int num_nodes, long long ldx, void* stream) {
  return launch<Layout::kRowMajor, float, Scale::kNone, Act::kF32>(
      band, nullptr, x, nullptr, nullptr, out, nb, W, block, F, num_nodes, ldx, stream);
}

// B2b: receiver-major int8 tiles, xq [(nb + 2W) * block, F] int8 in the
// W-shifted padded frame with one scale per block, ldx its row stride.
int cgt_banded_spmm_w8a8_rowmajor(const int8_t* band_q, const float* scales, const int8_t* xq,
                                  const float* xscales, float* out, int nb, int W, int block,
                                  int F, int num_nodes, long long ldx, void* stream) {
  return launch<Layout::kRowMajor, int8_t, Scale::kPerDot, Act::kInt8>(
      band_q, scales, nullptr, xq, xscales, out, nb, W, block, F, num_nodes, ldx, stream);
}

// B2c: each tile scaled while it is widened (rounded to bf16 with wrow_bf16).
int cgt_banded_spmm_quant_fused_dot(const int8_t* band_q, const float* scales, const float* x,
                                    float* out, int nb, int W, int block, int F,
                                    int num_nodes, long long ldx, int wrow_bf16,
                                    void* stream) {
  return wrow_bf16
             ? launch<Layout::kRowMajor, int8_t, Scale::kFoldedBf16, Act::kBf16>(
                   band_q, scales, x, nullptr, nullptr, out, nb, W, block, F, num_nodes, ldx,
                   stream)
             : launch<Layout::kRowMajor, int8_t, Scale::kFolded, Act::kBf16>(
                   band_q, scales, x, nullptr, nullptr, out, nb, W, block, F, num_nodes, ldx,
                   stream);
}

}  // extern "C"
