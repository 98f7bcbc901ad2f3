// Whole-model eval forwards of GCNConnectome (K1) and GraphSAGEConnectome
// (K2) in one launch each, for NVIDIA Hopper (built for sm_90a).
//
// Replaces the Pallas TPU kernels in connectome_gnn_tpu/ops/fused_pallas.py:
//   K1  fused_gcn_forward  / _fused_gcn_kernel   (pallas_call at :218)
//   K2  fused_sage_forward / _fused_sage_kernel  (pallas_call at :487)
//
// What bounded the first design (one block of f32 FMA loops per graph).
//   * Shared-memory loads, not arithmetic: each thread took 4 rows of one
//     output column, and each k-step read 4 A values (broadcasts) and one B
//     value for 4 FMAs, 5 loads for 4 FMAs.  An SM issues about one
//     warp-wide load a cycle against four warp-wide FMAs, so the ceiling was
//     about 20 % of the CUDA cores' f32 rate; at batch 512 the kernels took
//     11-15 % of it.
//   * At batch 16, 16 thread blocks ran on 132 SMs (88 % of the card idle),
//     each running 3 layers x 2 products one after another.
//
// What this design does.
//   * Tensor-core products on an exact bf16 split.  The graph's adjacency,
//     activations and per-layer products stay in f32 shared memory.  Each
//     warp builds mma.sync.m16n8k16 bf16 fragments from that memory with
//     scalar or 8-byte loads (ldmatrix cannot read f32), splits each f32
//     value in registers into hi + mid + lo bf16 terms (bf16_split.cuh,
//     exact), and takes six products a k16 step in the band body's order
//     (ops/band_mma.py SPLIT_PRODUCTS): lo*hi, mid*mid, hi*lo, mid*hi,
//     hi*mid into a fragment of their own, hi*hi into the dot, the two
//     added at the end.  No TF32.  A warp's unit is one 16-row tile times
//     1, 2 or 4 n8 tiles (unit_width: whichever finishes the product
//     soonest over the 8 warps; K1's h*W at most 2, K2's z at most 2): its
//     A fragment is loaded and split once a k-step, each B fragment once a
//     k-step and n8 tile right before its products, the next step's
//     operands are loaded under this step's products, and the epilogue
//     runs on the accumulator fragment before the store.  Only the last,
//     partial k16 step of a product masks its loads (layer 0's h*W, K = F =
//     5, is one such step: K padded to 16 by zeroing in registers).
//   * A thread-block cluster per graph at small batch.  The wrapper
//     (ops/fused.py cluster_size) picks cs CTAs a graph: the largest
//     cs <= min(8, ceil(n/16)) with B*cs <= 2*SMs (cs = 6 at batch 16 with
//     n = 88, cs = 1 from 133 graphs on).  CTA r owns a contiguous range of
//     whole m16 tiles of receiver rows (rank_rows), holds only those rows of
//     the adjacency and computes only those rows of each layer.  GCN keeps
//     its own rows of h and all of hw; SAGE keeps all of h.  At cs = 1 the
//     same code runs with block barriers in place of the cluster's.
//   * Rows are not padded: every array holds the rows it needs (n, or a
//     rank's own), and a fragment's rows past the data are clamped (their
//     sums are not stored) and its k past the data zeroed in registers.
//     The layout (make_layout, the one owner of it; the entries size their
//     own shared memory and cgt_fused_smem_bytes reports it) pads the row
//     strides where that fits in 227 KB: the adjacency to 4 mod 8 floats,
//     the feature arrays to 8 mod 16 (a stride of 64 or 128 floats would put
//     the 8 rows of a fragment in one bank).  Where it does not fit it keeps
//     the widths themselves, with bank conflicts, and then never takes more
//     than the first design's layout, which forward_auto's routing rule
//     counts: every shape routed to the first design still runs here.
//     Products over features (h*W) load A in mma's own k order with 8-byte
//     loads; products over the adjacency (adj*hw, adj*h) give thread t of a
//     quad the senders t, t+4, t+8, t+12 of the k16 step, in A and in B
//     alike (the sum over k does not depend on which k a register slot
//     holds), so that B, a [K, N] row-major array, is read by scalar loads
//     from four rows 8 banks apart.  tests/test_torch_fused_mma.py emulates
//     the banks of every fragment load.
//   * Loads: the adjacency by 16-byte asynchronous copies (cp.async, all in
//     flight at once) where its rows are a multiple of 4 floats, x by scalar
//     loads.  The weights are read from global memory through L1.
//   * K2's z overwrites h's own rows, which the other units of a row tile
//     still read.  Up to 128 features (z_in_registers) it goes in rounds
//     of whole row tiles: each unit's sums wait in registers for a block
//     barrier, then go in place.  Past that one row tile at a time goes
//     through a staging tile (16 rows, as the first design's chunk; the
//     layout always holds it).  Timed alone in turns (PERF.md 5), the
//     registers save a quarter of K2 at batch 512 (the staging is 6 %
//     faster at batch 16), so both stay.
//   * The head: each hidden unit, then each logit, by one warp.
//
// Why mma.sync and not wgmma.  wgmma reads B as bf16 from swizzled shared
// memory, so it would need three bf16 planes of hw (or h) and of W beside
// the f32 copies: at n = H = 128 about 190 KB more than the 203-212 KB the
// kernels already hold.  Its 64-row tiles would also pad 88 rows to 128,
// where m16 pads them to 96.
//
// What bounds it now (chip_smoke.py phase 5 on an H100 80GB HBM3 at 700 W,
// PERF.md): neither the tensor cores nor HBM, at 9-12 % of the f32 bound
// at batch 512.  A k16 step of a unit issues 11 instructions of split for
// every two f32 values it loads, and the weights' B fragments come from
// global memory as 4 rows of 32 bytes a load (4 L1 wavefronts for 32
// values, where the adjacency's scalar shared loads take 1).  At batch 16
// the fixed part (loads, degrees, pool, head: the launch with no layer)
// takes about a third of the kernel.
//
// The cluster's barrier protocol (cluster.sync() at cs > 1, __syncthreads()
// at cs = 1; every cluster.sync() is also a barrier of the block):
//   start   each CTA loads its rows; GCN sums its rows' column partials of
//           the degrees (in its hw region); sync (every CTA of the cluster
//           has started before any CTA touches another's shared memory);
//           each CTA adds the partials of every rank, in rank order,
//           through distributed shared memory; GCN: sync (no rank stores
//           hw over a peer's partials before the peer has read them).
//   GCN     per layer: own rows of hw = h*W stored into every rank's s_hw;
//           sync; own rows of adj_n*hw and the epilogue into own s_h; sync
//           (no rank stores the next layer's hw while a peer still reads
//           this layer's).
//   SAGE    per layer: own rows of agg = adj*h / wsum; sync (every rank is
//           done reading h); z = h*Ws + agg*Wa in rounds of whole own row
//           tiles: each unit's sums wait in registers for a block barrier
//           (every unit of the round has read its tile's rows of h and agg),
//           then go in place into every rank's s_h (a row tile's z reads
//           only its own rows of h); past 128 features one tile a round
//           through s_z, a block barrier before and after its copy; sync.
//   end     each CTA pools its rows (into a region dead by then); sync;
//           rank 0 adds the partial sums in rank order; sync (no CTA exits
//           while rank 0 may still read its shared memory); rank 0 runs
//           the head.
// Nothing is summed with atomics, so two launches give the same bits.
//
// Math (adj is receiver-major: adj[b, i, j] is the weight of edge j -> i):
//   K1  deg_j = sum_i adj[i, j] + 1 (a COLUMN sum), dinv = rsqrt(deg + 1e-8),
//       per layer h = relu((Â·hW + dinv²·hW) * s + t) with the conv bias
//       folded into the BatchNorm affine (s, t).
//   K2  wsum_i = sum_j adj[i, j] + 1e-8 (a ROW sum), per layer
//       agg = adj·h / wsum, z = h·W_self + agg·W_agg + b,
//       h = relu(z) * s + t (the BatchNorm affine without the bias).
//   Both end with the masked mean-pool (+1e-8) and relu(p·W1 + b1)·W2 + b2.
//   Padded node rows carry non-zero activations after layer 1 (the shift
//   makes them non-zero); only the masked pool keeps them out, exactly.
//
// Each C entry point returns the error of its attribute call or of its
// launch (cudaLaunchKernelEx), else cudaGetLastError(), as an int; 0 is
// success.  A cluster size the kernel cannot take returns
// cudaErrorInvalidClusterSize; the wrapper raises, it does not retry.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "bf16_split.cuh"  // split3

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kSmemLimit = 232448;  // bytes of shared memory one block may hold on sm_90 (227 KB)
constexpr int kZWidth = 2;          // n8 tiles at most in a unit of K2's z (two products' sums)
constexpr float kEps = 1e-8f;

// Whether K2 writes z in place from registers: where one row tile's units
// of z (kZWidth n8 tiles each) do not outnumber the warps, up to 128
// features; past that through its staging tile.
__host__ __device__ constexpr bool z_in_registers(int H) { return (H + 8 * kZWidth - 1) / (8 * kZWidth) <= kWarps; }

__host__ __device__ constexpr int pad_to(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
// Conflict-free row strides (floats) for rows of w floats.  a_stride = 4 mod
// 8, for the adjacency (A fragments by scalar loads: the 8 rows of a
// fragment 4 banks apart).  pair_stride = 8 mod 16, for the feature arrays
// (B fragments by scalar loads, 4 rows 8 banks apart; A fragments by 8-byte
// loads, 4 rows a phase 8 banks apart).
__host__ __device__ constexpr int a_stride(int w) { return w + ((4 - w) & 7); }
__host__ __device__ constexpr int pair_stride(int w) { return w + ((8 - w) & 15); }

// The shared-memory layout of one CTA, offsets in floats, the adjacency at
// 0.  Rows are not padded to whole tiles: a fragment's rows and k past the
// data are clamped or zeroed in registers.  R = the most rows a rank owns.
// Regions that are dead by then hold short-lived data: GCN's degree partial
// sums and both kernels' pool sums (H + 1) sit in hw (GCN, followed by dinv)
// or in the aggregate and z's tile (SAGE).
struct Layout {
  int R, Sa, Sh, Sw, Sg;  // strides: adjacency, h, GCN's hw or SAGE's z tile, SAGE's aggregate
  int h, hw, dinv, agg, z, wsum, hid, total;
};

inline Layout layout_with(bool sage, int n, int F, int H, int H2, int cs, bool padded) {
  Layout l{};
  const int T = (n + 15) / 16, D = imax(F, H), align = padded ? 4 : 1;
  l.R = imin(16 * ((T + cs - 1) / cs), n);
  l.Sa = padded ? a_stride(n) : n;
  l.Sh = l.Sg = padded ? pair_stride(D) : D;
  l.Sw = padded ? pair_stride(H) : H;
  l.h = pad_to(l.R * l.Sa, align);           // [R, Sa] own rows of the adjacency before it
  if (!sage) {
    l.hw = pad_to(l.h + l.R * l.Sh, align);  // [R, Sh] own rows of h before it
    l.dinv = pad_to(l.hw + n * l.Sw, align); // [n, Sw] every row of h·W before it
    l.hid = pad_to(l.dinv + n, align);       // [n] dinv before it
  } else {
    l.agg = pad_to(l.h + n * l.Sh, align);   // [n, Sh] every row of h before it
    l.z = pad_to(l.agg + l.R * l.Sg, align); // [R, Sg] own rows of the aggregate before it
    l.wsum = pad_to(l.z + 16 * l.Sw, align); // [16, Sw] one row tile of z before it
    l.hid = pad_to(l.wsum + l.R, align);     // [R] weight sums before it
  }
  // [H2] the head's hidden units; with the widths as strides, the last row
  // of a B operand is read up to 7 floats past its width (the n8 tile's end)
  l.total = l.hid + H2 + (padded ? 0 : 8);
  return l;
}

// The padded strides where they fit in kSmemLimit, else the widths
// themselves (bank conflicts, but never more than the first design's
// unpadded layout, which the routing rule in ops/fused.py counts).
inline Layout make_layout(bool sage, int n, int F, int H, int H2, int cs) {
  const Layout padded = layout_with(sage, n, F, H, H2, cs, true);
  return padded.total * (int)sizeof(float) <= kSmemLimit ? padded : layout_with(sage, n, F, H, H2, cs, false);
}

// Rank r's row tiles [t0, t1) of T: as even as can be, the first T % cs
// ranks one tile more.
struct Rows {
  int r0, r1, tiles;  // rows [r0, r1) of [0, n), in `tiles` m16 tiles (the last may be partial)
};

__device__ __forceinline__ Rows rank_rows(int n, int cs, int r) {
  const int T = (n + 15) / 16, q = T / cs, rem = T % cs;
  const int t0 = r * q + min(r, rem), t1 = t0 + q + (r < rem ? 1 : 0);
  return {16 * t0, min(16 * t1, n), t1 - t0};
}

struct Cluster {
  cg::cluster_group group;
  int cs;
  __device__ __forceinline__ void sync() {
    if (cs > 1) group.sync();
    else __syncthreads();
  }
  // p (in this CTA's shared memory) in rank r's shared memory
  __device__ __forceinline__ float* at(float* p, int r) {
    return cs > 1 ? group.map_shared_rank(p, r) : p;
  }
};

// ---------------------------------------------------------------------------
// Fragments and products
// ---------------------------------------------------------------------------

struct SplitA {
  uint32_t hi[4], mid[4], lo[4];
};
struct SplitB {
  uint32_t hi[2], mid[2], lo[2];
};
// A unit's sums: per n8 tile, the hi*hi dot and the five small products
template <int NT>
struct Acc {
  float dot[NT][4], corr[NT][4];
};
template <int NT>
struct Tiles {
  static constexpr int value = NT;
};

__device__ __forceinline__ void split_a(SplitA& a, int i, float x, float y) {
  split3(make_float2(x, y), a.hi[i], a.mid[i], a.lo[i]);
}
__device__ __forceinline__ void split_b(SplitB& b, int i, float x, float y) {
  split3(make_float2(x, y), b.hi[i], b.mid[i], b.lo[i]);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k16 step of the split product: the five small products into corr,
// then hi*hi into dot (ops/band_mma.py SPLIT_PRODUCTS, as (A, B) terms).
__device__ __forceinline__ void six_products(float (&dot)[4], float (&corr)[4], const SplitA& a,
                                             const SplitB& b) {
  mma(corr, a.lo, b.hi);
  mma(corr, a.mid, b.mid);
  mma(corr, a.hi, b.lo);
  mma(corr, a.mid, b.hi);
  mma(corr, a.hi, b.mid);
  mma(dot, a.hi, b.hi);
}

// Which loads a k16 step fetches for the next: none, a whole step's, or
// the last, partial step's (masked past K).
enum class Next { kNone, kWhole, kTail };
template <Next N>
using NextStep = std::integral_constant<Next, N>;

// One k16 step of a unit: split A into its bf16 terms and fetch the next
// step's A, then for each n8 tile split its B, fetch the next step's B of
// that tile and take the tile's six products, so the loads fly under the
// products and of the split operands only A and one tile's B are live.
// load_a(kk, tail) fetches step kk's raw f32 A operands into ra (in the
// fragment's register order), load_b(j, kk, tail) n8 tile j's B pairs into
// rb[j]; tail (a std::bool_constant) masks past K.
template <int NT, Next N, typename LoadA, typename LoadB>
__device__ __forceinline__ void k_step(Acc<NT>& acc, int kk, NextStep<N>, float (&ra)[8], float (&rb)[NT][4],
                                       LoadA& load_a, LoadB& load_b) {
  constexpr bool fetch = N != Next::kNone;
  using Tail = std::bool_constant<N == Next::kTail>;
  SplitA a;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_a(a, i, ra[2 * i], ra[2 * i + 1]);
  if constexpr (fetch) load_a(kk + 16, Tail{});
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    SplitB b;
    split_b(b, 0, rb[j][0], rb[j][1]);
    split_b(b, 1, rb[j][2], rb[j][3]);
    if constexpr (fetch) load_b(j, kk + 16, Tail{});
    six_products(acc.dot[j], acc.corr[j], a, b);
  }
}

// A unit's k16 loop over K: the whole steps' loads carry no mask; only the
// last, partial step's (where K is not a multiple of 16) are masked.
template <int NT, typename LoadA, typename LoadB>
__device__ __forceinline__ void k_loop(Acc<NT>& acc, int K, float (&ra)[8], float (&rb)[NT][4], LoadA load_a,
                                       LoadB load_b) {
  const int whole = K / 16 * 16;
  auto first = [&](auto tail) {
    load_a(0, tail);
#pragma unroll
    for (int j = 0; j < NT; ++j) load_b(j, 0, tail);
  };
  if (whole > 0) first(std::false_type{});
  else first(std::true_type{});
  int kk = 0;
  for (; kk + 16 < whole; kk += 16) k_step(acc, kk, NextStep<Next::kWhole>{}, ra, rb, load_a, load_b);
  if (whole < K) {
    if (whole > 0) k_step(acc, kk, NextStep<Next::kTail>{}, ra, rb, load_a, load_b), kk += 16;
    k_step(acc, kk, NextStep<Next::kNone>{}, ra, rb, load_a, load_b);
  } else {
    k_step(acc, kk, NextStep<Next::kNone>{}, ra, rb, load_a, load_b);
  }
}

// p[i * stride] where i < count, else 0; the index clamped so that nothing
// past the data is read (the last, partial k16 step of a product).
__device__ __forceinline__ float get(const float* p, int i, int count, int stride = 1) {
  const float v = p[imin(i, count - 1) * stride];
  return i < count ? v : 0.f;
}

// acc += A · B over the adjacency's senders: A the unit's row tile of an
// adjacency (stride lda, a_rows rows: the rest clamped, their sums not
// stored), B [K, N] row-major in shared memory (stride ldb; rows past K
// zero in registers; columns past N are read, up to the n8 tile's end, and
// their sums not stored).  Lane (g, t) holds rows g and
// g + 8 of A and column g of each n8 tile of B, at senders t, t+4, t+8,
// t+12 of the step (the sum over k does not depend on which k a register
// slot holds): scalar loads, A's rows 4 banks apart (lda = 4 mod 8), B's 8
// apart (ldb = 8 mod 16).
template <int NT>
__device__ __forceinline__ void adj_product(Acc<NT>& acc, const float* A, int lda, int a_rows, const float* Bm,
                                            int ldb, int K, int o0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = A + imin(g, a_rows - 1) * lda;
  const float* a8 = A + imin(g + 8, a_rows - 1) * lda;
  const float* b0 = Bm + o0 + g;
  float ra[8], rb[NT][4];
  auto load_a = [&](int kk, auto tail) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int s = kk + t + 4 * m, slot = (m & 1) + 4 * (m >> 1);
      if constexpr (decltype(tail)::value) {
        ra[slot] = get(a0, s, K), ra[slot + 2] = get(a8, s, K);
      } else {
        ra[slot] = a0[s], ra[slot + 2] = a8[s];
      }
    }
  };
  auto load_b = [&](int j, int kk, auto tail) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int s = kk + t + 4 * m;
      if constexpr (decltype(tail)::value) rb[j][m] = get(b0 + 8 * j, s, K, ldb);
      else rb[j][m] = b0[s * ldb + 8 * j];
    }
  };
  k_loop(acc, K, ra, rb, load_a, load_b);
}

// W[d, o] of a [K, N] row-major weight in global memory, zero outside it.
__device__ __forceinline__ float w_at(const float* __restrict__ W, int d, int o, int K, int N) {
  return d < K && o < N ? __ldg(W + (size_t)d * N + o) : 0.f;
}

// acc += A · W over features: A the unit's row tile (stride lda, a_rows
// rows) in shared memory, K = the layer's input width, W [K, N] in global
// memory (through L1).  mma's own k order: lane (g, t) reads columns 2t,
// 2t+1 and 2t+8, 2t+9 of rows g and g + 8, as four 8-byte loads where the
// rows are 8-byte aligned (lda = 8 mod 16 puts 4 rows a phase 8 banks
// apart), else and in the last, partial step as scalar loads.
template <int NT>
__device__ __forceinline__ void w_product(Acc<NT>& acc, const float* A, int lda, int a_rows,
                                          const float* __restrict__ W, int K, int N, int o0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = A + imin(g, a_rows - 1) * lda;
  const float* a8 = A + imin(g + 8, a_rows - 1) * lda;
  const bool pairs = (lda & 1) == 0 && (reinterpret_cast<uintptr_t>(A) & 7) == 0;
  float ra[8], rb[NT][4];
  auto load_a = [&](int kk, auto tail) {
    const int k = kk + 2 * t;
    if (!decltype(tail)::value && pairs) {
      const float2 v0 = *reinterpret_cast<const float2*>(a0 + k), v1 = *reinterpret_cast<const float2*>(a8 + k);
      const float2 v2 = *reinterpret_cast<const float2*>(a0 + k + 8);
      const float2 v3 = *reinterpret_cast<const float2*>(a8 + k + 8);
      ra[0] = v0.x, ra[1] = v0.y, ra[2] = v1.x, ra[3] = v1.y;
      ra[4] = v2.x, ra[5] = v2.y, ra[6] = v3.x, ra[7] = v3.y;
    } else {
      ra[0] = get(a0, k, K), ra[1] = get(a0, k + 1, K), ra[2] = get(a8, k, K), ra[3] = get(a8, k + 1, K);
      ra[4] = get(a0, k + 8, K), ra[5] = get(a0, k + 9, K), ra[6] = get(a8, k + 8, K), ra[7] = get(a8, k + 9, K);
    }
  };
  auto load_b = [&](int j, int kk, auto) {
    const int k = kk + 2 * t, o = o0 + 8 * j + g;
    rb[j][0] = w_at(W, k, o, K, N), rb[j][1] = w_at(W, k + 1, o, K, N);
    rb[j][2] = w_at(W, k + 8, o, K, N), rb[j][3] = w_at(W, k + 9, o, K, N);
  };
  k_loop(acc, K, ra, rb, load_a, load_b);
}

// The unit's sums, dot + corr, handed to epi(row in the tile, column, the
// value there, the value at column + 1); columns are even.
template <int NT, typename Epilogue>
__device__ __forceinline__ void finish(const Acc<NT>& acc, int o0, Epilogue epi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = o0 + 8 * j + 2 * t;
    epi(g, col, acc.dot[j][0] + acc.corr[j][0], acc.dot[j][1] + acc.corr[j][1]);
    epi(g + 8, col, acc.dot[j][2] + acc.corr[j][2], acc.dot[j][3] + acc.corr[j][3]);
  }
}

// v0 at p[col], v1 at p[col + 1], each where it is below `limit`; one
// 8-byte store where both are and the address is 8-byte aligned.
__device__ __forceinline__ void put2(float* p, int col, int limit, float v0, float v1) {
  if (col + 1 < limit && (reinterpret_cast<uintptr_t>(p + col) & 7) == 0) {
    *reinterpret_cast<float2*>(p + col) = make_float2(v0, v1);
  } else {
    if (col < limit) p[col] = v0;
    if (col + 1 < limit) p[col + 1] = v1;
  }
}

// The n8 tiles of a unit of a product over `tiles` row tiles and `ntiles`
// n8 tiles: of 4, 2 and 1 (at most `most`, dividing ntiles), the one whose
// units finish soonest over the warps, a unit's A fragments counted as two
// n8 tiles more (ties to the wider; 4 at batch 512 with n = 88, 1 in a
// cluster of 6).  With whole_tiles a round of units holds only whole row
// tiles (K2's z from registers), so a row tile's units may not outnumber
// the warps.
__device__ __forceinline__ int unit_width(int tiles, int ntiles, bool whole_tiles, int most) {
  int best = 1, best_cost = 1 << 30;
  for (int per = most; per >= 1; per >>= 1) {
    const int groups = ntiles / per;
    if (ntiles % per != 0 || (whole_tiles && groups > kWarps)) continue;
    const int rounds = whole_tiles ? (tiles + kWarps / groups - 1) / (kWarps / groups)
                                   : (tiles * groups + kWarps - 1) / kWarps;
    if (rounds * (per + 2) < best_cost) best = per, best_cost = rounds * (per + 2);
  }
  return best;
}

// f(Tiles<per>{}): the unit width as a compile-time constant.
template <typename F>
__device__ __forceinline__ void with_width(int per, F f) {
  if (per == 4) f(Tiles<4>{});
  else if (per == 2) f(Tiles<2>{});
  else f(Tiles<1>{});
}

// Calls body(Tiles<NT>, tile, o0) for this warp's units of a product over
// `tiles` row tiles and N output columns: a unit is one tile and NT n8
// tiles from column o0 (unit_width).
template <typename Body>
__device__ __forceinline__ void for_units(int tiles, int N, Body body, int most = 4) {
  const int ntiles = (N + 7) / 8, per = unit_width(tiles, ntiles, false, most), groups = ntiles / per;
  with_width(per, [&](auto nt) {
    for (int u = threadIdx.x / 32; u < tiles * groups; u += kWarps)
      body(nt, u / groups, 8 * decltype(nt)::value * (u % groups));
  });
}

// ---------------------------------------------------------------------------
// Loads, pool and head
// ---------------------------------------------------------------------------

// A 16-byte copy from global to shared memory that does not wait (cp.async).
__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copies_done() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Rows [r0, r0 + rows) of a graph's [n, n] adjacency into s (stride S).
// Where rows and S are multiples of 4 floats, 16-byte asynchronous copies,
// all in flight at once (copies_done() waits for them); else loads a warp a
// row.
__device__ __forceinline__ void load_adj_rows(const float* __restrict__ a, int n, int r0, int rows, float* s,
                                              int S) {
  if ((n & 3) == 0 && (S & 3) == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0) {
    const int q = n / 4;
    for (int idx = threadIdx.x; idx < rows * q; idx += kThreads) {
      const int li = idx / q, c = 4 * (idx - li * q);
      copy16_async(s + li * S + c, a + (size_t)(r0 + li) * n + c);
    }
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
    for (int li = warp; li < rows; li += kWarps)
      for (int c = lane; c < n; c += 32) s[li * S + c] = __ldg(a + (size_t)(r0 + li) * n + c);
  }
}

// Rows [r0, r0 + rows) of a graph's [n, F] features into s (stride S).
__device__ __forceinline__ void load_x_rows(const float* __restrict__ x, int F, int r0, int rows, float* s,
                                            int S) {
  for (int idx = threadIdx.x; idx < rows * F; idx += kThreads) {
    const int li = idx / F, c = idx - li * F;
    s[li * S + c] = __ldg(x + (size_t)(r0 + li) * F + c);
  }
}

// This rank's masked sums of h's columns over its `rows` rows (h's first
// at s_h, stride S; the mask's first at mask, in global memory) and its
// count of real nodes, into s_part[0..H].
__device__ __forceinline__ void pool_part(const float* s_h, int S, const uint8_t* __restrict__ mask, int rows,
                                          int H, float* s_part) {
  for (int o = threadIdx.x; o <= H; o += kThreads) {
    float s = 0.f;
    if (o < H) {
      for (int i = 0; i < rows; ++i) s += s_h[i * S + o] * (__ldg(mask + i) ? 1.f : 0.f);
    } else {
      for (int i = 0; i < rows; ++i) s += __ldg(mask + i) ? 1.f : 0.f;
    }
    s_part[o] = s;
  }
}

// Rank 0's mean-pool, in place over its s_part[0..H): every rank's partial
// sums added in rank order.
__device__ __forceinline__ void pool_sum(Cluster& cl, float* s_part, int H) {
  for (int o = threadIdx.x; o < H; o += kThreads) {
    float s = 0.f, cnt = 0.f;
    for (int r = 0; r < cl.cs; ++r) {
      const float* p = cl.at(s_part, r);
      s += p[o];
      cnt += p[H];
    }
    s_part[o] = s / (cnt + kEps);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The 2-layer MLP head on the pooled row: each hidden unit, then each
// logit, by one warp, lanes over its inputs.
__device__ __forceinline__ void head(const float* s_pool, float* s_hid, const float* __restrict__ w1,
                                     const float* __restrict__ b1, const float* __restrict__ w2,
                                     const float* __restrict__ b2, float* __restrict__ out_g, int H, int H2,
                                     int C) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (int j = warp; j < H2; j += kWarps) {
    float v = 0.f;
    for (int k = lane; k < H; k += 32) v = fmaf(s_pool[k], __ldg(w1 + (size_t)k * H2 + j), v);
    v = warp_sum(v);
    if (lane == 0) s_hid[j] = fmaxf(v + b1[j], 0.f);
  }
  __syncthreads();
  for (int c = warp; c < C; c += kWarps) {
    float v = 0.f;
    for (int j = lane; j < H2; j += 32) v = fmaf(s_hid[j], __ldg(w2 + (size_t)j * C + c), v);
    v = warp_sum(v);
    if (lane == 0) out_g[c] = v + b2[c];
  }
}

// ---------------------------------------------------------------------------
// The kernels: grid B * cs, clusters of cs CTAs, one cluster a graph
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 2) fused_gcn_kernel(
    const float* __restrict__ x, const float* __restrict__ adj,
    const uint8_t* __restrict__ mask, const float* __restrict__ w_in,
    const float* __restrict__ w_h, const float* __restrict__ scale,
    const float* __restrict__ shift, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, float* __restrict__ out, int n, int F,
    int H, int H2, int C, int L, int cs, const Layout l) {
  extern __shared__ __align__(16) float smem[];
  float* s_adj = smem;            // [R, Sa] own rows, normalized
  float* s_h = smem + l.h;        // [R, Sh] own rows of h
  float* s_hw = smem + l.hw;      // [n, Sw] every row of h·W
  float* s_dinv = smem + l.dinv;  // [n]
  float* s_degp = s_hw;           // [n] this rank's column sums, before the layers
  float* s_part = s_hw;           // [H + 1] this rank's pool sums and count, after them
  Cluster cl{cg::this_cluster(), cs};
  const int rank = cs > 1 ? (int)cl.group.block_rank() : 0;
  const size_t g = blockIdx.x / cs;
  const Rows rows = rank_rows(n, cs, rank);
  const int own = rows.r1 - rows.r0;

  load_adj_rows(adj + g * n * n, n, rows.r0, own, s_adj, l.Sa);
  load_x_rows(x + g * n * F, F, rows.r0, own, s_h, l.Sh);
  copies_done();
  __syncthreads();

  // degree of sender j: column sum over receivers i, this rank's rows
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float d = 0.f;
    for (int i = 0; i < own; ++i) d += s_adj[i * l.Sa + j];
    s_degp[j] = d;
  }
  cl.sync();
  // ... every rank's partial sums in rank order, plus the self-loop
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float deg = cl.at(s_degp, 0)[j];
    for (int r = 1; r < cs; ++r) deg += cl.at(s_degp, r)[j];
    s_dinv[j] = rsqrtf(deg + 1.f + kEps);
  }
  __syncthreads();
  for (int li = threadIdx.x / 32; li < own; li += kWarps) {  // a warp a row
    const float di = s_dinv[rows.r0 + li];
    for (int j = threadIdx.x & 31; j < n; j += 32) s_adj[li * l.Sa + j] = di * s_adj[li * l.Sa + j] * s_dinv[j];
  }
  cl.sync();  // no rank stores h·W over a peer's column sums before the peer has read them

  for (int layer = 0; layer < L; ++layer) {
    const int Din = layer == 0 ? F : H;
    const float* W = layer == 0 ? w_in : w_h + (size_t)(layer - 1) * H * H;
    const float* s_l = scale + layer * H;
    const float* t_l = shift + layer * H;
    // own rows of hw = h·W, into every rank's s_hw (units of at most two n8
    // tiles: with four, this kernel's registers spill)
    for_units(rows.tiles, H, [&](auto nt, int tile, int o0) {
      Acc<decltype(nt)::value> acc{};
      const int vr = imin(16, own - 16 * tile);
      w_product(acc, s_h + 16 * tile * l.Sh, l.Sh, vr, W, Din, H, o0);
      finish(acc, o0, [&](int row, int col, float v0, float v1) {
        const int i = rows.r0 + 16 * tile + row;
        if (row < vr)
          for (int r = 0; r < cs; ++r) put2(cl.at(s_hw, r) + i * l.Sw, col, H, v0, v1);
      });
    }, 2);
    cl.sync();
    // own rows of h = relu((adj_n·hw + dinv²·hw) * s + t)
    for_units(rows.tiles, H, [&](auto nt, int tile, int o0) {
      Acc<decltype(nt)::value> acc{};
      const int vr = imin(16, own - 16 * tile);
      adj_product(acc, s_adj + 16 * tile * l.Sa, l.Sa, vr, s_hw, l.Sw, n, o0);
      finish(acc, o0, [&](int row, int col, float v0, float v1) {
        const int li = 16 * tile + row, i = rows.r0 + li;
        if (row >= vr || col >= H) return;  // past the rank's rows or the layer's width
        const float* hw = s_hw + i * l.Sw;
        const float h0 = fmaxf((v0 + s_dinv[i] * s_dinv[i] * hw[col]) * s_l[col] + t_l[col], 0.f);
        const float h1 = col + 1 < H
            ? fmaxf((v1 + s_dinv[i] * s_dinv[i] * hw[col + 1]) * s_l[col + 1] + t_l[col + 1], 0.f)
            : 0.f;
        put2(s_h + li * l.Sh, col, H, h0, h1);
      });
    });
    cl.sync();
  }

  pool_part(s_h, l.Sh, mask + g * n + rows.r0, own, H, s_part);
  cl.sync();
  if (rank == 0) pool_sum(cl, s_part, H);
  cl.sync();
  if (rank == 0) head(s_part, smem + l.hid, w1, b1, w2, b2, out + g * C, H, H2, C);
}

__global__ void __launch_bounds__(kThreads, 2) fused_sage_kernel(
    const float* __restrict__ x, const float* __restrict__ adj,
    const uint8_t* __restrict__ mask, const float* __restrict__ w_self_in,
    const float* __restrict__ w_agg_in, const float* __restrict__ w_self_h,
    const float* __restrict__ w_agg_h, const float* __restrict__ bias,
    const float* __restrict__ scale, const float* __restrict__ shift,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ out, int n, int F, int H, int H2, int C, int L, int cs, const Layout l) {
  extern __shared__ __align__(16) float smem[];
  float* s_adj = smem;            // [R, Sa] own rows, raw
  float* s_h = smem + l.h;        // [n, Sh] every row of h
  float* s_agg = smem + l.agg;    // [R, Sg] own rows of the aggregate
  float* s_z = smem + l.z;        // [16, Sw] one row tile of z, past 128 features
  float* s_wsum = smem + l.wsum;  // [R]
  float* s_part = s_agg;          // [H + 1] this rank's pool sums and count, after the layers
  Cluster cl{cg::this_cluster(), cs};
  const int rank = cs > 1 ? (int)cl.group.block_rank() : 0;
  const size_t g = blockIdx.x / cs;
  const Rows rows = rank_rows(n, cs, rank);
  const int own = rows.r1 - rows.r0;

  load_adj_rows(adj + g * n * n, n, rows.r0, own, s_adj, l.Sa);
  load_x_rows(x + g * n * F, F, 0, n, s_h, l.Sh);
  copies_done();
  __syncthreads();

  // weight sum of receiver i: ROW sum over senders j
  for (int i = threadIdx.x; i < own; i += kThreads) {
    float w = 0.f;
    for (int j = 0; j < n; ++j) w += s_adj[i * l.Sa + j];
    s_wsum[i] = w + kEps;
  }
  __syncthreads();

  for (int layer = 0; layer < L; ++layer) {
    const int Din = layer == 0 ? F : H;
    const float* Ws = layer == 0 ? w_self_in : w_self_h + (size_t)(layer - 1) * H * H;
    const float* Wa = layer == 0 ? w_agg_in : w_agg_h + (size_t)(layer - 1) * H * H;
    const float* b_l = bias + layer * H;
    const float* s_l = scale + layer * H;
    const float* t_l = shift + layer * H;
    // own rows of agg = adj·h / wsum
    for_units(rows.tiles, Din, [&](auto nt, int tile, int o0) {
      Acc<decltype(nt)::value> acc{};
      const int vr = imin(16, own - 16 * tile);
      adj_product(acc, s_adj + 16 * tile * l.Sa, l.Sa, vr, s_h, l.Sh, n, o0);
      finish(acc, o0, [&](int row, int col, float v0, float v1) {
        const int li = 16 * tile + row;
        if (row < vr) put2(s_agg + li * l.Sg, col, Din, v0 / s_wsum[li], v1 / s_wsum[li]);
      });
    });
    cl.sync();  // every rank is done reading h before any rank stores z
    // own rows of z = relu(h·Ws + agg·Wa + b) * s + t, into every rank's h;
    // a unit of z takes h·Ws, then agg·Wa, of its row tile
    auto z_unit = [&](auto nt, int tile, int o0) {
      Acc<decltype(nt)::value> acc{};
      const int vr = imin(16, own - 16 * tile);
      w_product(acc, s_h + (rows.r0 + 16 * tile) * l.Sh, l.Sh, vr, Ws, Din, H, o0);
      w_product(acc, s_agg + 16 * tile * l.Sg, l.Sg, vr, Wa, Din, H, o0);
      return acc;
    };
    auto z_of = [&](int col, float v) { return fmaxf(v + b_l[col], 0.f) * s_l[col] + t_l[col]; };
    if (z_in_registers(H)) {
      // rounds of whole row tiles: each unit's sums wait in registers until
      // every unit of its tile has read the tile's rows, then go in place
      const int zt = ((H + 7) / 8 + kZWidth - 1) / kZWidth * kZWidth;  // past H: zeros, not stored
      const int per = unit_width(rows.tiles, zt, true, kZWidth), groups = zt / per;
      const int per_round = kWarps / groups, warp = threadIdx.x / 32;
      with_width(per, [&](auto nt) {
        const int o0 = 8 * decltype(nt)::value * (warp % groups);
        for (int t0 = 0; t0 < rows.tiles; t0 += per_round) {
          const int tile = t0 + warp / groups;
          const bool active = warp / groups < per_round && tile < rows.tiles;
          Acc<decltype(nt)::value> acc{};
          if (active) acc = z_unit(nt, tile, o0);
          __syncthreads();  // every unit of the round has read its tile's rows
          if (!active) continue;
          finish(acc, o0, [&](int row, int col, float v0, float v1) {
            const int i = rows.r0 + 16 * tile + row;
            if (i >= rows.r1 || col >= H) return;
            const float z1 = col + 1 < H ? z_of(col + 1, v1) : 0.f;
            for (int r = 0; r < cs; ++r) put2(cl.at(s_h, r) + i * l.Sh, col, H, z_of(col, v0), z1);
          });
        }
      });
    } else {
      // a row tile at a time through the staging tile
      for (int c = 0; c < rows.tiles; ++c) {
        for_units(1, H, [&](auto nt, int, int o0) {
          finish(z_unit(nt, c, o0), o0, [&](int row, int col, float v0, float v1) {
            if (col < H) put2(s_z + row * l.Sw, col, H, z_of(col, v0), col + 1 < H ? z_of(col + 1, v1) : 0.f);
          });
        }, kZWidth);
        __syncthreads();
        const int i0 = rows.r0 + 16 * c, vr = imin(16, own - 16 * c);
        for (int idx = threadIdx.x; idx < vr * H; idx += kThreads) {
          const int row = idx / H, col = idx - row * H;
          for (int r = 0; r < cs; ++r) cl.at(s_h, r)[(i0 + row) * l.Sh + col] = s_z[row * l.Sw + col];
        }
        __syncthreads();
      }
    }
    cl.sync();
  }

  pool_part(s_h + rows.r0 * l.Sh, l.Sh, mask + g * n + rows.r0, own, H, s_part);
  cl.sync();
  if (rank == 0) pool_sum(cl, s_part, H);
  cl.sync();
  if (rank == 0) head(s_part, smem + l.hid, w1, b1, w2, b2, out + g * C, H, H2, C);
}

// One launch of a grid of B clusters of cs CTAs (no cluster attribute at
// cs = 1) with the layout make_layout gives (its last kernel argument) and
// its shared memory, after the kernel's preconditions.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), bool sage, int B, int n, int F, int H, int H2, int cs, void* stream,
                   Args... args) {
  if (cs < 1 || cs > kMaxCluster || cs > (n + 15) / 16) return cudaErrorInvalidClusterSize;
  const Layout l = make_layout(sage, n, F, H, H2, cs);
  const int smem_bytes = l.total * (int)sizeof(float);
  if (smem_bytes > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * cs);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = (cudaStream_t)stream;
  config.attrs = attr;
  config.numAttrs = cs > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, args..., l);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

int cgt_fused_gcn_forward(
    const float* x, const float* adj, const uint8_t* mask, const float* w_in,
    const float* w_h, const float* scale, const float* shift, const float* w1,
    const float* b1, const float* w2, const float* b2, float* out, int B, int n,
    int F, int H, int H2, int C, int L, int cs, void* stream) {
  return (int)launch(fused_gcn_kernel, false, B, n, F, H, H2, cs, stream,
                     x, adj, mask, w_in, w_h, scale, shift, w1, b1, w2, b2, out, n, F, H, H2, C, L, cs);
}

int cgt_fused_sage_forward(
    const float* x, const float* adj, const uint8_t* mask, const float* w_self_in,
    const float* w_agg_in, const float* w_self_h, const float* w_agg_h,
    const float* bias, const float* scale, const float* shift, const float* w1,
    const float* b1, const float* w2, const float* b2, float* out, int B, int n,
    int F, int H, int H2, int C, int L, int cs, void* stream) {
  return (int)launch(fused_sage_kernel, true, B, n, F, H, H2, cs, stream,
                     x, adj, mask, w_self_in, w_agg_in, w_self_h, w_agg_h, bias, scale, shift,
                     w1, b1, w2, b2, out, n, F, H, H2, C, L, cs);
}

// The shared memory (bytes) one CTA of K1 (sage = 0) or K2 (sage = 1) takes
// when a graph spans cs CTAs: make_layout's total, which the entries above
// launch with.
int cgt_fused_smem_bytes(int sage, int n, int F, int H, int H2, int cs) {
  return make_layout(sage != 0, n, F, H, H2, cs).total * (int)sizeof(float);
}

const char* cgt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
