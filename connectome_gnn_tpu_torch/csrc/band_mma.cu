// The band SpMM body on Hopper's tensor cores (built for sm_90a): wgmma
// products on tiles staged by TMA into an mbarrier ring, one kernel body with
// two roles and two band types.
//
// Replaces the Pallas TPU kernels
//   in connectome_gnn_tpu/ops/banded_quant.py:
//   K3  banded_spmm_quant over the int8 band (pallas_call at :820)    role A, int8
//   in connectome_gnn_tpu/ops/banded_pallas.py:
//   K7  banded_spmm_pallas over a bf16 band (pallas_call at :66)      role A, bf16
//   in benchmarks/quant_kernel_diag.py:
//   B2a banded_spmm_bf16_pallas             (pallas_call at :92)      role A, bf16
//   in benchmarks/fm_kernel_diag.py:
//   B3a _fm_pipeline (pallas_call at :130) reached by fm_bf16_band :271   role B, bf16
// K4-K6, K7 over a float32 band, B2b and B2c stay on csrc/banded_spmm.cu,
// and the probes on csrc/fm_pipeline.cu.
//
// Math.  The band holds, for row block rb and diagonal d in [0, 2W], one
// b x b tile: bf16, or int8 with one f32 scale.  x-hat is x rounded to bf16
// (round to nearest even) in the W-shifted padded frame: frame block rb + d
// holds the senders of node block rb + d - W, zeros outside [0, num_nodes).
//   Role A (row-major: K3, K7 and B2a): receiver-major tiles T[rb, d][r, s],
//   node-major frame x-hat[blk, s, f], the int8 band's tiles scaled:
//     out[rb*b + r, f] = sum_d scale[rb, d] * sum_s T[rb, d][r, s] * x-hat[rb + d, s, f]
//   Role B (feature-major, fm_bf16_band): transposed tiles tT[rb, d][s, r],
//   feature-major frame xT-hat[f, blk*b + s], one f32 scale per tile:
//     out[f, rb*b + r] = sum_d scale[rb, d] * sum_s xT-hat[f, (rb + d)*b + s] * tT[rb, d][s, r]
// As GEMMs, role A has M = receivers, N = features, and role B M =
// features, N = receivers; in both the K axis is the senders, A is K-major
// and B is MN-major (wgmma's transposed-B form).  Products are
// wgmma.mma_async.m64nNk16.f32.bf16.bf16: an int8 band is widened to bf16
// first, which is exact (every int8 is a bf16); every bf16 x bf16 product
// is exact in f32 and the sums are f32, so the kernel differs from the
// plain version only in the order of its f32 sums.  Both roles take each
// tile's dot in a fragment of its own (the tile's first k-step starts it
// with scale-d 0) and then add it into the sum in f32, times the tile's
// scale where the band has scales, as the TPU kernels do
// (banded_quant.py:804-812, banded_pallas.py:53-57, fm_kernel_diag.py:284-287);
// the sum over the diagonals then has the plain version's order.
//
// What bounds it on this card.  At the 1M-node shape (NB = 4096, b = 256,
// W = 2, F = 64) the dense tiles need 172 GFLOP: about 0.17 ms on the
// tensor cores (989 TFLOP/s bf16).  The band's bytes at 3.35 TB/s take 0.80
// ms in bf16 (2.68 GB) and 0.40 ms in int8 (1.34 GB); with x and the f32
// output the least time is 0.96 and 0.56 ms.  So the kernel is a streaming
// problem: its time is set by how fully it keeps HBM busy.  The CUDA-core
// bodies it replaces did 86 G f32 multiply-adds (8 ms) behind 2-6 KB stages.
//
// What the design does about it.
//   * Staging by TMA (cp.async.bulk.tensor.3d) with 128-byte swizzle into a
//     ring of kStages = 6 stages, one full and one empty mbarrier a stage.
//     A stage holds 16 KB of band, 128 receivers of one tile by 128 bytes of
//     senders (64 bf16 or 128 int8 senders), and the frame's matching
//     senders by 64 features (8 or 16 KB): 24 KB stages for a bf16 band, 32
//     KB for an int8 one, up to 144 or 192 KB in flight per SM.  One
//     producer thread issues the loads; two consumer warpgroups run wgmma
//     on the staged tiles and release each stage when their products are
//     done.  The band is loaded under an L2 evict_first policy and the
//     frame under evict_last, so the band's stream does not push out the
//     frame blocks that the neighbouring units read next.
//   * An int8 band (K3) is widened in registers: wgmma takes a bf16 A
//     operand from registers.  Each consumer thread reads the bytes of its
//     A fragment (receivers 16 * warp + lane / 4 and + 8, senders 2 * (lane
//     % 4) + {0, 1, 8, 9} of each 16-sender k-step) from the swizzled stage
//     with 16-bit shared loads, conflict-free, and turns each pair into
//     bf16x2 with four integer and bf16 instructions (widen2).  No bf16
//     tile goes back to shared memory, so no proxy fence is needed, and the
//     widening of k-step k + 1 runs while k-step k's wgmma is in flight.
//   * The operands are 3-D tensor maps, [NB*D tiles, b, b] for the band and
//     [blocks, b, F] (role A) or [F, blocks, b] (role B) for the frame, so
//     every sender or receiver outside a tile or a frame block, and every
//     feature past F, is the hardware's zero fill: no mask in the loop.  The
//     maps are built on the host for every call and passed as
//     __grid_constant__ parameters.  cuTensorMapEncodeTiled is a driver
//     function; it is reached through the runtime's driver entry point, so
//     the library links no libcuda.
//   * Persistent thread blocks, one per SM, each walking the work units
//     (row block, 128-receiver tile, 64-feature tile) blockIdx.x,
//     blockIdx.x + gridDim.x, ...: the ring never drains between units, the
//     consumers' stores overlap the next unit's loads, each band byte is
//     read once, and all blocks move through the row blocks together, so
//     the 2W + 1 frame blocks of a unit mostly come from the 50 MB L2.  At
//     the main shape that is 8,192 units, 62.06 a block, so the last round
//     leaves little of the card idle.
//   * Each consumer warpgroup owns 64 receivers of a unit and runs one
//     m64n64 product a k-step: receivers x features in role A, features x
//     receivers in role B; a tile's dot and the sum are 64 f32 registers a
//     thread.  The sums are stored from registers, masked to b, num_nodes
//     and F.
//   * TMA needs 16-byte global strides, so the wrappers pad what this body
//     cannot take with zeros: b to a multiple of 16 and role A's features
//     to a multiple of 8.  The kernel reads the padded block b_pad and
//     stores in the caller's block b.
//   * On the H100 80GB HBM3 at 700 W (chip_smoke.py phases 10, 19 and 22,
//     1M-node shape) a bf16 band's launch takes 1.08 ms, 89 % of its
//     bound, beside torch.bmm's 1.07-1.09 ms; K3's launch over the int8
//     band 0.65 ms, 87 % of its 0.56 ms bound, where torch.bmm over the
//     dequantized band takes 3.64 ms.  The first bf16 version, 128
//     receivers a warpgroup (two m64n64 or one m64n128 products) in five 40
//     KB stages over 4,096 units with no L2 policy, took 1.14-1.16 ms.
//
// Each C entry point returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for arguments it does not take (and for a tensor
// map the driver refuses), as an int; 0 is success.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

enum class Role { kRowMajor, kFeatureMajor };

constexpr int kConsumerGroups = 2;                     // warpgroups running wgmma
constexpr int kThreads = (kConsumerGroups + 1) * 128;  // + one producer warpgroup
constexpr int kConsumerWarps = kConsumerGroups * 4;
constexpr int kStages = 6;
constexpr int kRowBytes = 128;                         // a staged row: the 128-byte swizzle span
constexpr int kGroupR = 64;                            // receivers a consumer warpgroup
constexpr int kTileR = kGroupR * kConsumerGroups;      // receivers a unit
constexpr int kTileF = 64;                             // features a unit: one 128-byte bf16 row
constexpr int kBoxBytes = 64 * kRowBytes;              // 64 rows of 128 bytes: 8 KB
constexpr int kBandBytes = kTileR * kRowBytes;         // 16 KB of band a stage
constexpr int kSwizzleAtom = 1024;                     // 8 rows of 128 bytes

// A stage of a band of type Band: 128 bytes of senders (kK of them) for each
// of 128 receivers, and those senders' frame rows of 64 bf16 features.
template <typename Band>
struct Stage {
  static constexpr int kK = kRowBytes / sizeof(Band);  // senders a stage: 64 bf16, 128 int8
  static constexpr int kSteps = kK / 16;               // wgmma k-steps of 16 senders
  static constexpr int kFrameBytes = kK * kTileF * 2;  // 8 or 16 KB
  static constexpr int kBytes = kBandBytes + kFrameBytes;
  static constexpr int kSmemBytes = kStages * kBytes + kSwizzleAtom;
  static_assert(kBytes % kSwizzleAtom == 0, "stages keep the 1024-byte swizzle alignment");
};

struct Params {
  const float* scales;  // [nb, D]: role B and the int8 band; null for role A's bf16 band
  float* out;
  int nb, W;
  int b;       // the output's block: receivers stored per row block
  int b_pad;   // the block of the band and the frame the maps read
  int F;       // features stored
  int mtiles, ftiles;
  long long n;    // output nodes stored
  long long ldo;  // output row stride, elements
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// An L2 eviction policy for TMA loads: evict_first for the band, read once,
// evict_last for the frame blocks that neighbouring units read again.
__device__ __forceinline__ uint64_t l2_policy(bool keep) {
  uint64_t policy;
  if (keep) {
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  } else {
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  }
  return policy;
}

// One 3-D box of a tensor map into shared memory under an L2 policy;
// completion counts its bytes on the mbarrier (the whole box, the zero fill
// included).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "l"(policy)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading byte offset (MN-major: from one 64-element column of the
// swizzle atom to the next; unused K-major), stride byte offset (from one
// group of 8 rows to the next), swizzle mode 1 = 128 B.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (+)= A * B, m64n64k16, f32 += bf16 x bf16: A K-major, B MN-major
// (transposed); `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same product with A from registers: this thread's fragment of the 64 x
// 16 bf16 A tile, a[0] = (row q, k 2t..2t+1), a[1] = (row q + 8, same k),
// a[2] = (row q, k 2t+8..2t+9), a[3] = (row q + 8, same k), for q = 16 *
// warp + lane / 4 and t = lane % 4, lower k in the low half.
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Keeps A fragments in registers of their own until the wgmma that reads
// them has completed (the compiler sees only the issue).
template <int N>
__device__ __forceinline__ void fence_fragments(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Two int8 values, bits 0-7 and 8-15 of v, as bf16x2 (the first in the low
// half), exactly: each byte's low seven bits m become the bf16 128 + m
// (exponent 7, mantissa m), from which fma subtracts 128, or 256 where the
// byte's sign bit is set.  Every result is an integer in [-128, 127].
__device__ __forceinline__ uint32_t widen2(uint32_t v) {
  const uint32_t s = __byte_perm(v, 0, 0x4140);          // byte 0 -> bits 0-7, byte 1 -> 16-23
  const uint32_t m = (s & 0x007F007Fu) | 0x43004300u;    // 128 + low seven bits
  const uint32_t c = (s & 0x00800080u) | 0x43004300u;    // 128, or 256 for a negative byte
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(out) : "r"(c), "r"(0xBF80BF80u), "r"(m));  // m - c
  return out;
}

// Two neighbouring outputs (v0 at out[i], v1 at out[i + 1]), each where it is
// inside the output; one 8-byte store when both are and i is even.
__device__ __forceinline__ void store2(float* out, long long i, bool ok0, bool ok1, float v0, float v1) {
  if (ok0 && ok1 && (i & 1) == 0) {
    *reinterpret_cast<float2*>(out + i) = make_float2(v0, v1);
  } else {
    if (ok0) out[i] = v0;
    if (ok1) out[i + 1] = v1;
  }
}

template <Role kRole, typename Band>
__global__ void __launch_bounds__(kThreads, 1)
    band_mma_kernel(__grid_constant__ const CUtensorMap band_map,
                    __grid_constant__ const CUtensorMap frame_map, const Params p) {
  using S = Stage<Band>;
  constexpr bool kRowMajor = kRole == Role::kRowMajor;
  constexpr bool kInt8 = std::is_same_v<Band, int8_t>;  // widened in registers
  constexpr bool kScaled = kInt8 || !kRowMajor;
  static_assert(kRowMajor || !kInt8, "role B takes a bf16 band");
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: stages start on that grid
  const uint32_t ring = (smem_u32(smem_raw) + kSwizzleAtom - 1) & ~(uint32_t)(kSwizzleAtom - 1);

  const int D = 2 * p.W + 1;
  const int nk = (p.b_pad + S::kK - 1) / S::kK;  // sender chunks of a tile
  const long long units = (long long)p.nb * p.mtiles * p.ftiles;
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (group == kConsumerGroups) {
    // the producer: one thread keeps the ring full
    if (threadIdx.x != kConsumerGroups * 128) return;
    const uint64_t stream = l2_policy(false), keep = l2_policy(true);
    int stage = 0;
    uint32_t phase = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const int ft = (int)(u % p.ftiles);
      const int mt = (int)((u / p.ftiles) % p.mtiles);
      const int rb = (int)(u / ((long long)p.ftiles * p.mtiles));
      for (int d = 0; d < D; ++d) {
        for (int kc = 0; kc < nk; ++kc) {
          const uint32_t full = smem_u32(&full_bar[stage]);
          mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1);
          mbar_expect_tx(full, S::kBytes);
          const uint32_t band = ring + stage * S::kBytes, frame = band + kBandBytes;
          const int tile = rb * D + d, blk = rb + d, s0 = kc * S::kK, r0 = mt * kTileR, f0 = ft * kTileF;
          if constexpr (kRowMajor) {
            // band box {kK senders, 128 receivers, 1 tile}; frame box {64 features, kK senders, 1 block}
            tma_load(band, &band_map, full, s0, r0, tile, stream);
            tma_load(frame, &frame_map, full, f0, s0, blk, keep);
          } else {
            // two band boxes {64 receivers, 64 senders, 1 tile}; frame box {64 senders, 1 block, 64 features}
#pragma unroll
            for (int c = 0; c < kTileR / 64; ++c)
              tma_load(band + c * kBoxBytes, &band_map, full, r0 + 64 * c, s0, tile, stream);
            tma_load(frame, &frame_map, full, s0, blk, f0, keep);
          }
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    // the consumers: warpgroup `group` owns receivers [64 * group, 64 * group + 64)
    // of a unit, one m64n64 product: receivers x features in role A, features
    // x receivers in role B
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int quad = lane / 4, pair = 2 * (lane % 4);
    // an int8 band's A fragment: this thread's receivers 16 * warp + quad and
    // + 8 of its warpgroup's 64, rows of the stage's band box read directly
    const uint8_t* const ring_ptr = smem_raw + (ring - smem_u32(smem_raw));
    const int frag_row = (kGroupR * group + 16 * warp + quad) * kRowBytes;
    int stage = 0;
    uint32_t phase = 0;
    float acc[32], dot[32];  // the sum, and the tile's dot
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const int ft = (int)(u % p.ftiles);
      const int mt = (int)((u / p.ftiles) % p.mtiles);
      const int rb = (int)(u / ((long long)p.ftiles * p.mtiles));
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      for (int d = 0; d < D; ++d) {
        // the tile's scale, read while its products run (a bf16 band in role
        // A has none: 1 * dot is exact)
        const float scale = kScaled ? __ldg(p.scales + (size_t)rb * D + d) : 1.f;
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(smem_u32(&full_bar[stage]), phase);
          const uint32_t band = ring + stage * S::kBytes, frame = band + kBandBytes;
          if constexpr (kInt8) {
            // the fragment's bytes of all k-steps: in the 128-byte swizzle the
            // 16-byte chunk k of row r sits at chunk k ^ (r % 8), and r % 8 is
            // quad for both rows
            const uint8_t* const rows = ring_ptr + stage * S::kBytes + frag_row;
            uint32_t raw[S::kSteps][4], a[S::kSteps][4];
#pragma unroll
            for (int k = 0; k < S::kSteps; ++k) {
              const int c = ((k ^ quad) << 4) + pair;
              raw[k][0] = *reinterpret_cast<const uint16_t*>(rows + c);
              raw[k][1] = *reinterpret_cast<const uint16_t*>(rows + 8 * kRowBytes + c);
              raw[k][2] = *reinterpret_cast<const uint16_t*>(rows + c + 8);
              raw[k][3] = *reinterpret_cast<const uint16_t*>(rows + 8 * kRowBytes + c + 8);
            }
            fence_operands(dot);
#pragma unroll
            for (int k = 0; k < S::kSteps; ++k) {
              // widened outside any wgmma group: each k-step is a group of its own
#pragma unroll
              for (int j = 0; j < 4; ++j) a[k][j] = widen2(raw[k][j]);
              wgmma_fence();  // orders the fragment's registers before the product reads them
              // B: frame rows (senders) of 64 features, MN-major, k-step 16 rows
              wgmma_m64n64_rs(dot, a[k], smem_desc(frame + k * 16 * kRowBytes, kBoxBytes, 1024),
                              (kc | k) != 0);  // the tile's first k-step starts its dot
              wgmma_commit();
            }
            wgmma_wait_all();
            fence_fragments(a);
          } else {
            fence_operands(dot);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < S::kSteps; ++k) {
              uint64_t a, b;
              if constexpr (kRowMajor) {
                // A: band rows (receivers) K-major, 128 bytes a row, k-step 32 bytes;
                // B: frame rows (senders) of 64 features, MN-major, k-step 16 rows
                a = smem_desc(band + kGroupR * group * kRowBytes + k * 32, 0, 1024);
                b = smem_desc(frame + k * 16 * kRowBytes, kBoxBytes, 1024);
              } else {
                // A: frame rows (features) K-major; B: band rows (senders) of this
                // group's 64-receiver box, MN-major
                a = smem_desc(frame + k * 32, 0, 1024);
                b = smem_desc(band + group * kBoxBytes + k * 16 * kRowBytes, kBoxBytes, 1024);
              }
              wgmma_m64n64(dot, a, b, (kc | k) != 0);  // the tile's first k-step starts its dot
            }
            wgmma_commit();
            wgmma_wait_all();
          }
          fence_operands(dot);
          __syncwarp();
          if (lane == 0) mbar_arrive(smem_u32(&empty_bar[stage]));
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
        // the tile's dot into the sum
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += scale * dot[i];
      }
      // store: fragment entry i is row 16 * warp + quad (+ 8 for i % 4 >= 2),
      // column 8 * (i / 4) + pair (+ 1 for odd i); rows are receivers in
      // role A, features in role B
      const long long block0 = (long long)rb * p.b;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = 16 * warp + quad + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + pair;
        if constexpr (kRowMajor) {
          const int r = mt * kTileR + kGroupR * group + row, f = ft * kTileF + col;
          const long long node = block0 + r;
          const bool row_ok = r < p.b && node < p.n;
          store2(p.out, node * p.ldo + f, row_ok && f < p.F, row_ok && f + 1 < p.F, acc[i], acc[i + 1]);
        } else {
          const int f = ft * kTileF + row, r = mt * kTileR + kGroupR * group + col;
          const long long node = block0 + r;
          const bool f_ok = f < p.F;
          store2(p.out, (long long)f * p.ldo + node, f_ok && r < p.b && node < p.n,
                 f_ok && r + 1 < p.b && node + 1 < p.n, acc[i], acc[i + 1]);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no
// libcuda at link time); null if the driver does not give it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                    cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A 3-D tensor map of bf16 or int8 elements (the int8 band is mapped as
// bytes; the zero fill is int8 0): dims innermost first, strides of dims 1
// and 2 in bytes, a box of box0 x box1 x box2 elements, 128-byte swizzle,
// zero fill.
template <typename T>
bool tensor_map(CUtensorMap* map, const T* base, uint64_t d0, uint64_t d1, uint64_t d2,
                uint32_t box0, uint32_t box1, uint32_t box2) {
  static_assert(std::is_same_v<T, __nv_bfloat16> || std::is_same_v<T, int8_t>, "bf16 or int8");
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * sizeof(T), d0 * d1 * sizeof(T)};
  const cuuint32_t box[3] = {box0, box1, box2};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return encode(map, type, 3, const_cast<T*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool valid(int nb, int W, int b, int b_pad, int F) {
  return nb > 0 && W >= 0 && b > 0 && b <= b_pad && b_pad % 16 == 0 && F > 0 &&
         (long long)nb * (2 * W + 1) < 0x7fffffffLL;
}

template <Role kRole, typename Band>
int launch(const CUtensorMap& band_map, const CUtensorMap& frame_map, Params p, void* stream) {
  p.mtiles = (p.b_pad + kTileR - 1) / kTileR;
  const long long units = (long long)p.nb * p.mtiles * p.ftiles;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  auto kernel = band_mma_kernel<kRole, Band>;
  constexpr int smem = Stage<Band>::kSmemBytes;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)(units < sms ? units : sms);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(band_map, frame_map, p);
  return (int)cudaGetLastError();
}

// Role A over a bf16 band (scales null) or an int8 band with its scales.
template <typename Band>
int launch_rowmajor(const Band* band, const float* scales, const __nv_bfloat16* frame, float* out,
                    int nb, int W, int block, int block_pad, int F, int F_pad, int num_nodes,
                    void* stream) {
  if (!valid(nb, W, block, block_pad, F) || F_pad < F || F_pad % 8 != 0 || num_nodes <= 0 ||
      num_nodes > (long long)nb * block || (std::is_same_v<Band, int8_t> && scales == nullptr))
    return (int)cudaErrorInvalidValue;
  const uint64_t bp = block_pad, D = 2 * W + 1;
  CUtensorMap band_map, frame_map;
  if (!tensor_map(&band_map, band, bp, bp, (uint64_t)nb * D, Stage<Band>::kK, kTileR, 1) ||
      !tensor_map(&frame_map, frame, (uint64_t)F_pad, bp, (uint64_t)nb + 2 * W, kTileF,
                  Stage<Band>::kK, 1))
    return (int)cudaErrorInvalidValue;
  Params p{scales, out, nb, W, block, block_pad, F, 0, (F_pad + kTileF - 1) / kTileF, num_nodes, F};
  return launch<Role::kRowMajor, Band>(band_map, frame_map, p, stream);
}

}  // namespace

extern "C" {

// K3 banded_spmm_quant: band_q [nb, 2W+1, block_pad, block_pad] int8
// (receiver-major tiles, zero past block) with scales [nb, 2W+1]; frame
// [nb + 2W, block_pad, F_pad] bf16, x rounded to bf16 in the W-shifted
// padded frame (zero past block and F); out [num_nodes, F] float32, node
// rb * block + r.
int cgt_banded_spmm_quant(const int8_t* band_q, const float* scales, const __nv_bfloat16* frame,
                          float* out, int nb, int W, int block, int block_pad, int F, int F_pad,
                          int num_nodes, void* stream) {
  return launch_rowmajor(band_q, scales, frame, out, nb, W, block, block_pad, F, F_pad, num_nodes,
                         stream);
}

// K7 over a bf16 band, and B2a: band [nb, 2W+1, block_pad, block_pad] bf16
// (receiver-major tiles, zero past block); frame and out as for K3.
int cgt_banded_spmm_direct_bf16(const __nv_bfloat16* band, const __nv_bfloat16* frame, float* out,
                                int nb, int W, int block, int block_pad, int F, int F_pad,
                                int num_nodes, void* stream) {
  return launch_rowmajor(band, static_cast<const float*>(nullptr), frame, out, nb, W, block,
                         block_pad, F, F_pad, num_nodes, stream);
}

// B3a fm_bf16_band: band_T [nb, 2W+1, block_pad, block_pad] bf16
// (transposed tiles, zero past block) with scales [nb, 2W+1]; x_pad [F,
// (nb + 2W) * block_pad] bf16 in the W-shifted padded frame; outT [F, ldo]
// float32, column rb * block + r for the first num_cols columns.
int cgt_fm_bf16_band(const __nv_bfloat16* band_T, const float* scales, const __nv_bfloat16* x_pad,
                     float* outT, int nb, int W, int block, int block_pad, int F, long long ldo,
                     long long num_cols, void* stream) {
  if (!valid(nb, W, block, block_pad, F) || num_cols <= 0 || num_cols > (long long)nb * block ||
      ldo < num_cols)
    return (int)cudaErrorInvalidValue;
  const uint64_t bp = block_pad, D = 2 * W + 1, blocks = (uint64_t)nb + 2 * W;
  constexpr int kK = Stage<__nv_bfloat16>::kK;
  CUtensorMap band_map, frame_map;
  if (!tensor_map(&band_map, band_T, bp, bp, (uint64_t)nb * D, 64, kK, 1) ||
      !tensor_map(&frame_map, x_pad, bp, blocks, (uint64_t)F, kK, 1, kTileF))
    return (int)cudaErrorInvalidValue;
  Params p{scales, outT, nb, W, block, block_pad, F, 0, (F + kTileF - 1) / kTileF, num_cols, ldo};
  return launch<Role::kFeatureMajor, __nv_bfloat16>(band_map, frame_map, p, stream);
}

}  // extern "C"
