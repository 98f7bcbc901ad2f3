// The band SpMM body on Hopper's tensor cores (built for sm_90a): wgmma
// products on tiles staged by TMA into an mbarrier ring, one kernel body with
// two roles, three band types and, for K5 and B2b, s8 x s8 products.
//
// Replaces the Pallas TPU kernels
//   in connectome_gnn_tpu/ops/banded_quant.py:
//   K3  banded_spmm_quant over the int8 band (pallas_call at :820)    role A, int8
//   K4  banded_spmm_quant_fm (pallas_call at :284); also the backward of
//       banded_spmm_quant_fm_grad (:743), K4 over the transposed band  role B, int8
//   K5  banded_spmm_quant_fm_w8a8 (pallas_call at :434)     role A's schedule, int8 x int8
//   K6  banded_spmm_quant_blocked (pallas_call at :564), forward and
//       backward of banded_spmm_quant_blocked_grad (:639)          role B, int8, blocked
//   in connectome_gnn_tpu/ops/banded_pallas.py:
//   K7  banded_spmm_pallas (pallas_call at :66)                       role A, bf16 or f32
//   in benchmarks/quant_kernel_diag.py:
//   B2a banded_spmm_bf16_pallas             (pallas_call at :92)      role A, bf16
//   B2b banded_spmm_w8a8                    (pallas_call at :173)     role A, int8 x int8
//   B2c banded_spmm_quant_fused_dot         (pallas_call at :250)     role A, int8
//   in benchmarks/fm_kernel_diag.py:
//   B3a _fm_pipeline (pallas_call at :130) reached by fm_bf16_band :271   role B, bf16
//       by fm_dma_only :157, the staging probe: role B's ring, no dots    role B, int8, copy-plus-add
//       and by fm_w8a8 :545, K5's function on given operands: K5's launch
//   B3b fm_compute_only (pallas_call at :242), on a bf16 frame        role B, int8, panel map
//   B3c fm_deep     (pallas_call at :393), K4's function: K4's launch     role B, int8
//   B3d fm_blocked  (pallas_call at :495), K6's function on a bf16 frame  role B, int8, blocked
//
// Math.  The band holds, for row block rb and diagonal d in [0, 2W], one
// b x b tile: bf16, f32, or int8 with one f32 scale.  x-hat is x in the
// W-shifted padded frame: frame block rb + d holds the senders of node block
// rb + d - W, zeros outside [0, num_nodes) (K6: the caller's whole padded
// frame, no sender mask); rounded to bf16 (round to nearest even), or for
// the f32 band split into three bf16 frames (below).
//   Role A (row-major: K3, K7, B2a, B2c): receiver-major tiles T[rb, d][r, s],
//   node-major frame x-hat[blk, s, f], the int8 band's tiles scaled:
//     out[rb*b + r, f] = sum_d scale[rb, d] * sum_s T[rb, d][r, s] * x-hat[rb + d, s, f]
//   Role B (feature-major: K4, K6, B3a fm_bf16_band, B3c, B3d): transposed tiles
//   tT[rb, d][s, r], feature-major frame xT-hat[f, blk*b + s], one f32 scale
//   per tile:
//     out[f, rb*b + r] = sum_d scale[rb, d] * sum_s xT-hat[f, (rb + d)*b + s] * tT[rb, d][s, r]
//   K6 and B3d store the same sums blocked, out[(rb*F + f)*b + r].
//   K5 takes the transposed tiles and an int8 frame xq-hat, x quantized per
//   frame block with one scale xscale[blk] each:
//     out[f, rb*b + r] = sum_d fl(scale[rb, d] * xscale[rb + d])
//                          * float(sum_s xq-hat[f, (rb + d)*b + s] * tT[rb, d][s, r])
//   B2b takes role A's receiver-major tiles and K5's int8 frame, and stores
//   node-major:
//     out[rb*b + r, f] = sum_d fl(scale[rb, d] * xscale[rb + d])
//                          * float(sum_s T[rb, d][r, s] * xq-hat[f, (rb + d)*b + s])
//   B3b computes role B's sums for every row rb = i*R + r of chunk i of R
//   row blocks over one panel: band row (r + i) mod R of the first R, frame
//   block (r + d + i) mod (R + 2W) of a window of R + 2W blocks, scale row
//   rb; chunk i* (the largest even chunk) stores at column r*b + c, every
//   other chunk's sums go into a one-float sink.
//   B3a dma-only computes no dot.  It stages every stage that B3d stages
//   (the int8 band on the bf16 feature-major frame) and stores, for f < F
//   <= b, one f32 add of two exactly widened values:
//     out[f, rb*b + c] = float(xT-hat[f, rb*b + c]) + float(tT[rb, 0][f, c])
//   (the padded frame, not shifted back; sender row f of diagonal 0's tile).
// As GEMMs, role A has M = receivers, N = features, and role B M =
// features, N = receivers; in both the K axis is the senders, A is K-major
// and B is MN-major (wgmma's transposed-B form).  K5 and B2b have role A's
// M and N, and both operands K-major (the 8-bit forms have no transposed
// one).  Products are wgmma.mma_async.m64nNk16.f32.bf16.bf16, never TF32
// (K5's and B2b's m64n64k32.s32.s8.s8); every bf16 x bf16 product is exact
// in f32.  Each tile's dot is taken in a fragment of its
// own (the tile's first k-step starts it with scale-d 0) and then added into
// the sum in f32, times the tile's scale where it has one, as the TPU
// kernels do (banded_quant.py:804-812, banded_pallas.py:53-57,
// fm_kernel_diag.py:284-287); the sum over the diagonals then has the plain
// version's order.  By band type:
//   * bf16 (K7, B2a, B3a): the staged tile is wgmma's A (role A) or B (role
//     B) as it is.  The kernel differs from the plain version only in the
//     order of its f32 sums.
//   * int8 in role B (K4, K6, B3c, B3d): widened to bf16 exactly, into
//     shared memory (there the band is wgmma's B operand, which only shared
//     memory feeds).  K4's (so B3c's) and K6's x stays f32 in the frame and
//     each thread rounds its A fragment to bf16 in registers
//     (cvt.rn.bf16x2.f32, the plain version's .to(torch.bfloat16) bit for
//     bit).  B3d's frame is bf16 already (its TPU function's own operand),
//     as is that of the feature-major bf16-frame launch (B3c's function on
//     pad_xT's frame, which chip_smoke.py times against K4's launch): it is
//     the A fragment as it is.  Every product is exact, and the tile's
//     scale goes on its dot, the plain version's order.
//   * int8 in role A (K3, B2c): widened to bf16 in registers, exactly (every int8 is a
//     bf16), the tile's scale on its dot: K3's order, which B2c takes too
//     unless wrow_bf16.  B2c's plain version folds the scale into the tile
//     first, fl(s * q), a product of up to 24 bits: K3's order differs from
//     it by one f32 rounding a product, of the same size as the order of
//     the sums.  With wrow_bf16 the fold is done here as the plain version
//     does it: q widened to f32 exactly, times the scale in f32 (__fmul_rn),
//     rounded to bf16 (cvt.rn.bf16x2.f32), the plain version's two
//     roundings; every product is then exact, and the tile's dot is added
//     with scale 1.
//   * int8 x int8 (K5, B2b): wgmma.mma_async.m64n64k32.s32.s8.s8, each
//     tile's dot exact in s32 and then in f32 (|dot| <= 127^2 * b < 2^24
//     for b <= 1040), times fl(scale * xscale), then added, each rounding
//     apart (__fmul_rn, __fadd_rn): the plain version bit for bit.
//   * f32 (K7): wgmma has no f32 x f32 form and TF32 keeps 10 bits, so each
//     f32 value a is split exactly into three bf16 terms, hi = rn(a), mid =
//     rn(a - hi), lo = a - hi - mid (a - hi and lo are exact in f32, and lo
//     has at most 8 significant bits), the band in registers and x by the
//     wrapper into three frames.  Six products a k-step, lo*hi, mid*mid,
//     hi*lo, mid*hi, hi*mid (into a fragment of the unit's own, `corr`) and
//     hi*hi (into the tile's dot), leave out mid*lo, lo*mid and lo*lo, each
//     under 2^-24 of the product.  The small products need a fragment of
//     their own: the tensor cores round each accumulation at the magnitude
//     of the fragment it goes into, and 80 further accumulations a tile at
//     the dot's magnitude would break the 1e-5 gate against the exact
//     product (tests/test_torch_band_mma.py emulates it); in `corr` they
//     round 2^8 times finer, and `corr` joins the sum once a unit.
//     Documented limits: a non-finite band or x entry gives NaN where the
//     plain version may give +-Inf; entries beyond bf16's largest finite
//     value (3.39e38) are out of range, and entries under about 2^-110 in
//     magnitude (not zero) lose the bits that fall below bf16's normal
//     range in lo.  The wrappers check neither.
//
// What bounds it on this card.  At the 1M-node shape (NB = 4096, b = 256,
// W = 2, F = 64) the dense tiles need 172 GFLOP: about 0.17 ms on the
// tensor cores (989 TFLOP/s bf16), six times that (1.04 ms) for the f32
// band's six products.  The band's bytes at 3.35 TB/s take 1.60 ms in f32
// (5.37 GB), 0.80 ms in bf16 (2.68 GB) and 0.40 ms in int8 (1.34 GB); with
// x and the f32 output the least time is 1.76, 0.96 and 0.56 ms.  So the
// kernel is a streaming problem: its time is set by how fully it keeps HBM
// busy.  The CUDA-core bodies it replaces did 86 G f32 multiply-adds (8 ms)
// behind 2-17 KB stages; on the CUDA cores (67 TFLOP/s f32) those take 2.56
// ms at best.
//
// What the design does about it.
//   * Staging by TMA (cp.async.bulk.tensor.3d) with 128-byte swizzle into a
//     ring of kStages = 6 stages, one full and one empty mbarrier a stage.
//     A stage holds 16 KB of band, 128 receivers of one tile by 128 bytes of
//     senders (32 f32, 64 bf16 or 128 int8 senders), and the frame's
//     matching senders by 64 features (bf16; three frames for the f32 band):
//     24 KB stages for a bf16 band, 28 KB for an f32 one, 32 KB for an int8
//     one, up to 144, 168 or 192 KB in flight per SM.  One producer thread
//     issues the loads; two consumer warpgroups run wgmma on the staged
//     tiles and release each stage when their products are done.  The band
//     is loaded under an L2 evict_first policy and the frame under
//     evict_last, so the band's stream does not push out the frame blocks
//     that the neighbouring units read next.  Role B over the int8 band
//     stages 64 senders: one 8 KB band box of 128 receivers (128 bytes) by
//     64 senders, and two 8 KB boxes of the f32 frame, 32 senders (128
//     bytes) by 64 features each (K4, K6: 24 KB stages, 144 KB in the
//     ring), or one 8 KB box of the bf16 frame, 64 senders by 64 features
//     (B3a dma-only, B3b, B3d and the feature-major bf16 frame: 16 KB
//     stages, 96 KB in the ring).  K5 stages 128 senders: a 16 KB box of the transposed
//     tile, 128 sender rows of 128 receivers, and an 8 KB box of the int8
//     frame, 64 feature rows of 128 senders (24 KB stages, 144 KB in the
//     ring; 620 stages a block at the main shape, role B's 1,241).  B2b
//     stages the same bytes: role A's box of the receiver-major tile, 128
//     receiver rows of 128 sender bytes, and K5's frame box.  B3b
//     reads its 10.5 MB panel again for every chunk, so its band boxes are
//     loaded under evict_last too: the panel and the window stay in L2,
//     and B3b times role B with the HBM stream taken out.
//   * An int8 or f32 band becomes wgmma's A operand in registers.  Each
//     consumer thread reads its A fragment (receivers 16 * warp + lane / 4
//     and + 8 of its warpgroup's 64, senders 2 * (lane % 4) + {0, 1, 8, 9}
//     of each 16-sender k-step) from the swizzled stage, where the 16-byte
//     chunk c of row r sits at chunk c ^ (r % 8) and r % 8 is lane / 4 for
//     both rows: int8 pairs by 16-bit loads, widened by widen2 (K3, B2c) or
//     fold2 (B2c with wrow_bf16); f32 pairs by 64-bit loads, split by split3.
//     A warp's loads cover each bank twice (64-bit) or once (16-bit): no
//     conflicts.  No tile goes back to shared memory, so no proxy fence is
//     needed, and the widening of k-step k + 1 runs while k-step k's wgmma
//     is in flight.
//   * K5's band is wgmma's A operand in registers too, but its staged tile
//     is transposed (sender rows of 128 receiver bytes) and a thread's s8
//     fragment register holds four consecutive senders of one receiver: a
//     gather across four rows.  The fragment's row order is free, as long
//     as the output rows take the same order, so each thread gets two
//     adjacent receivers (row 16 * warp + lane / 4 is receiver 16 * warp +
//     2 * (lane / 4), row + 8 the next): one 16-bit load at a sender row
//     serves both, and two byte permutes a pair of loads and one a register
//     build the fragment, 8 loads and 8 prmt a k32-step.  The K order is
//     not free (it is the frame box's), but the order of a thread's own
//     four loads is: lanes t and t + 2 of a quad read rows four apart,
//     which under the swizzle fall on the same chunk, so lanes with t >= 2
//     take their senders rotated by one, and every 16-bit load of a warp
//     meets each bank once (tests/test_torch_band_mma.py emulates the
//     gather, two wavefronts a load without the rotation).  The frame box
//     is wgmma's B through a K-major descriptor, the frame's rows as they
//     are.  As for K3, no tile goes back to shared memory: no proxy fence,
//     no named barrier.  The sums are stored feature-major from the
//     permuted rows, a thread's two receivers side by side, so a warp's
//     8-byte stores fill whole 32-byte sectors.
//   * B2b's receiver-major tile needs no gather: a thread's s8 register,
//     four consecutive senders of one receiver, is one aligned 32-bit load
//     of its row (receiver 16 * warp + lane / 4, and + 8) at chunk (2k + h)
//     ^ (row % 8), byte 4 * (lane % 4), for k-group h of k32-step k; a
//     warp's load covers 8 rows of distinct row % 8, so 8 distinct chunks:
//     each bank once (tests/test_torch_band_mma.py emulates it).  4 loads a
//     k32-step, no permute; the fragment's rows are in their natural order,
//     so the sums are stored node-major as K3 stores them.  The frame box
//     and its descriptor are K5's.
//   * An int8 band in role B is wgmma's B operand, which comes only from
//     shared memory.  Each consumer warpgroup widens its own 64 receivers
//     of the stage's int8 box into a swizzled bf16 box of 64 receivers by
//     64 senders, the layout of the bf16 band's box, so the same B
//     descriptor reads it: a thread reads 16 int8 (chunk c ^ (s % 8) of
//     sender row s) and writes 32 bytes of bf16 (chunks 2c' and 2c' + 1,
//     each ^ (s % 8)), eight rows of one chunk a quarter warp, so no bank
//     is met twice.  The box goes into one of two buffers of the
//     warpgroup's own, apart from the ring.  Written by the generic proxy,
//     read by wgmma's async proxy: each thread issues
//     fence.proxy.async.shared::cta after its stores, then the warpgroup
//     meets at a named barrier (bar.sync 1 + group, 128), and only then are
//     the products issued.  K4's and K6's frame stays f32: each thread
//     loads its A fragment (features 16 * warp + lane / 4 and + 8, senders
//     as above) by 64-bit loads and rounds it with cvt.rn.bf16x2.f32, so the
//     wrapper makes no pass over x.  A bf16 frame is loaded by 32-bit
//     loads (bf16 pairs, 16-byte chunk 2k, + 1 for senders + 8, of the row,
//     ^ (row % 8): a warp's loads meet each bank once) and used as it is.
//     Once the widening and the fragment have read a stage, the warps
//     release it, before the products run.  A
//     stage's products stay in flight while the next stage is widened into
//     the other buffer and its pairs are loaded; then wgmma.wait_group 0
//     frees the fragment registers for the new pairs.  The products that
//     read a buffer, two stages back, are done before it is written again:
//     every thread waited for them before the warpgroup's barrier of the
//     stage between.  After a tile's last stage every thread waits for its
//     products, so its dot can join the sum.  ptxas serializes every wgmma
//     of an instantiation (C7518, "WG.DP in divergent path") where that
//     wait sits under a test of the tile's last stage inside the stage
//     loop, as it once did in every role B instantiation over the int8
//     band (a version with two fragment sets chosen by the buffer's parity
//     drew it too): the wait is after the loop.
//   * B3a dma-only is role B's producer and ring with a consumer that does
//     no work in its stages: no widening, no proxy fence, no named barrier,
//     no wgmma.  It measures what the ring alone costs.  Each consumer
//     warpgroup keeps its 64 receivers by the unit's 64 features in role
//     B's accumulator layout (features 16 * warp + lane / 4 and + 8 by
//     receivers 8j + 2 * (lane % 4) and + 1) and reads two of the unit's
//     D * ceil(b_pad / 64) stages, both of diagonal 0: x from the frame box
//     of sender chunk 2 * mt + group (a receiver's x is the sender of the
//     same index in frame block rb), one 32-bit load of a bf16 pair at
//     chunk j ^ (row % 8); and the band from the band box of sender chunk
//     ft (a stage's 64 senders are a unit's 64 features, so feature f's
//     tile row is sender row f), one 16-bit load of an int8 pair at chunk
//     (4 * group + j / 2) ^ (row % 8).  Each load of a warp meets every
//     bank once.  Every other stage is waited for and released untouched.
//     TMA loads and mbarrier transactions cannot be eliminated, so every
//     staged byte is moved: 2.68 GB into shared memory at the main shape,
//     B3d's stream.  The widened boxes stay allocated (the Stage is B3d's),
//     so the launch has B3d's shared memory and occupancy.
//   * The operands are 3-D tensor maps, [NB*D tiles, b, b] for the band and
//     [blocks, b, F] (role A; [3 * blocks, b, F] for the f32 band's three
//     frames, frame s at block s * blocks + blk) or [F, blocks, b] (role B)
//     for the frame, so every sender or receiver outside a tile or a frame
//     block, and every feature past F, is the hardware's zero fill: no mask
//     in the loop.  K4 reads the caller's f32 xT [F, >= n] through a 2-D map
//     of extent num_nodes at sender (rb + d - W) * b + s: a coordinate below
//     0 or past num_nodes is zero fill, which is K4's sender mask.  K6 reads
//     its padded blocked frame [blocks, F, b] through a 3-D map, and B3d
//     its bf16 one; the feature-major bf16-frame launch reads B3a's frame
//     map [F, blocks, b].  The maps
//     are built on the host for every call and
//     passed as __grid_constant__ parameters.  cuTensorMapEncodeTiled is a
//     driver function; it is reached through the runtime's driver entry
//     point, so the library links no libcuda.
//   * Persistent thread blocks, one per SM, each walking the work units
//     (row block, 128-receiver tile, 64-feature tile) blockIdx.x,
//     blockIdx.x + gridDim.x, ...: the ring never drains between units, the
//     consumers' stores overlap the next unit's loads, each band byte is
//     read once, and all blocks move through the row blocks together, so
//     the 2W + 1 frame blocks of a unit mostly come from the 50 MB L2.  At
//     the main shape that is 8,192 units, 62.06 a block, so the last round
//     leaves little of the card idle.
//   * Each consumer warpgroup owns 64 receivers of a unit and runs m64n64
//     products: receivers x features in role A, features x receivers in
//     role B; the sum, a tile's dot (and the f32 band's `corr`) are 32 f32
//     registers a thread each.  The sums are stored from registers, masked
//     to b, num_nodes and F: node-major (role A), feature-major (K4, B3a,
//     B3c) or blocked (K6, B3d).
//   * TMA needs 16-byte global strides, so the wrappers pad what this body
//     cannot take with zeros: b to a multiple of 16 and role A's features
//     to a multiple of 8; for K4, K6 and B3d, an x whose block is not a
//     multiple of 16, whose row stride is not a multiple of 4 elements
//     (K4) or whose base is not 16-byte aligned, into one padded copy.  The
//     kernel reads the padded block b_pad and stores in the caller's block
//     b.  At the main shape nothing is padded.
//   * A role B stage over the int8 band reads 64 senders.  Where b_pad is
//     not a multiple of 64, a tile's last stage reaches past the block.
//     The 3-D frame maps (K6, B3a, B3d, the feature-major bf16 frame) have
//     a sender extent of b_pad, so those senders are the hardware's zero
//     fill.  K4's 2-D map over xT (or its padded copy) reads on into the
//     next node blocks' x, times band rows that are zero fill, where a
//     non-finite x would give 0 * Inf = NaN in row blocks that the plain
//     version never lets read that block; so each thread sets those
//     k-steps of its A fragment to zero by a select in registers, in an
//     instantiation of its own (kPastBlock) that K4's entry point takes
//     where b_pad % 64 != 0.  The main shape runs the instantiation without
//     it: a select, or a branch uniform over the launch, in its loop slowed
//     K4's launch there.
//   * On the H100 80GB HBM3 at 700 W (chip_smoke.py phases 10, 16, 19 and
//     22, 1M-node shape) a bf16 band's launch takes 1.08 ms, 89 % of its
//     bound, beside torch.bmm's 1.07-1.09 ms; K3's launch over the int8
//     band 0.65 ms, 87 % of its 0.56 ms bound, where torch.bmm over the
//     dequantized band takes 3.64 ms.  The first bf16 version, 128
//     receivers a warpgroup (two m64n64 or one m64n128 products) in five 40
//     KB stages over 4,096 units with no L2 policy, took 1.14-1.16 ms.  K7
//     over the f32 band and B2c took 8.18 and 7.88-7.91 ms on the CUDA-core
//     body this one replaced; their times here are in PERF.md.  Role B
//     over the int8 band: K4's launch (and B3c's, which is K4's) 1.11 ms,
//     K6's 1.10 (9.0, 9.3 and 8.4 on the CUDA-core bodies; the f32
//     torch.bmm 5.3), half of the 0.56 ms bound; on a bf16 frame, the same
//     band and body, 0.85 ms feature-major and 0.84 ms blocked (B3d).  With
//     the tile-end wait under a test of the last stage (C7518, above) K6
//     took 1.31 ms and the bf16 frame 1.00.  B3b, the same stages with its
//     panel in L2, takes 0.78 ms: 0.62 us a stage without the HBM stream
//     against B3d's 0.67 with it.  B3a dma-only, the same ring and stream
//     with no work in its stages, takes 0.67 ms (2.4 ms on the CUDA-core
//     body it replaced), 0.53 us a stage, 78 % of its stream's 0.52 ms
//     bound: the ring with its stream is 80 % of B3d's time, and the
//     stage's own work (the widening, the proxy fence, the named barrier
//     and the wgmma wait), 0.62 us a stage alone, overlaps it to 0.67.
//     Taking that work away would save at most a fifth; the rest is the
//     ring at 2.6 TB/s from HBM.  Two variants did not help: a
//     cluster of the two receiver tiles with the frame box multicast to
//     both (2.38 ms), and eight stages (1.13).  K5's launch takes 0.64 ms,
//     87 % of its 0.56 ms bound (4.25 ms on the CUDA-core body); B2b's
//     0.59-0.61 ms, 92-95 % of the same bound.
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

#include "bf16_split.cuh"  // pack_bf16x2, split3

namespace {

// Role A is row-major (K3, K7, B2a, B2c).  Role B is feature-major: the
// frame a 2-D map over xT (K4; B3a's bf16 frame is a 3-D map) with the
// output [F, n], or blocked (K6): the frame a 3-D map over [blocks, F, b],
// the output [nb, F, b].
enum class Role { kRowMajor, kFeatureMajor, kBlocked };
// Where an int8 band's scale goes: on the tile's dot (K3, B2c, role B), or
// folded into the tile and rounded to bf16 as it is widened (B2c wrow_bf16).
enum class Fold { kOnDot, kIntoTileBf16 };
// What a role B launch over the int8 band adds to K4's: nothing; the A
// fragment's k-steps past a block that is not a multiple of 64 set to zero
// (K4's kPastBlock); B3b's panel map (kPanel); or, in place of its
// consumers' work, B3a dma-only's copy-plus-add (kDmaOnly).
enum class Variant { kPlain, kPastBlock, kPanel, kDmaOnly };

constexpr int kConsumerGroups = 2;                     // warpgroups running wgmma
constexpr int kThreads = (kConsumerGroups + 1) * 128;  // + one producer warpgroup
constexpr int kConsumerWarps = kConsumerGroups * 4;
constexpr int kRowBytes = 128;                         // a staged row: the 128-byte swizzle span
constexpr int kGroupR = 64;                            // receivers a consumer warpgroup
constexpr int kTileR = kGroupR * kConsumerGroups;      // receivers a unit
constexpr int kTileF = 64;                             // features a unit: one 128-byte bf16 row
constexpr int kBoxBytes = 64 * kRowBytes;              // 64 rows of 128 bytes: 8 KB
constexpr int kSwizzleAtom = 1024;                     // 8 rows of 128 bytes

// A stage of a band of type Band in role kRole, with a frame of type Frame:
// 128 bytes of senders (kK of them) for each of 128 receivers, and those
// senders' rows of 64 features in each of the band's kFrames frames (three
// for the f32 band's split x).  Role B over the int8 band (kWiden) stages 64
// senders by 128 receivers of band and their rows of the frame, f32 (K4,
// K6) or bf16 (B3b, B3c, B3d); after the ring come each consumer
// warpgroup's two bf16 boxes of the widened band.  K5 (kS8: an int8 frame,
// s8 products) stages 128 senders by 128 receivers of the transposed tile
// and their 64 features' rows of 128 bytes of the int8 frame; B2b (kS8 in
// role A) the receiver-major tile's 128 receivers by 128 senders and the
// same frame rows.  Every other stage's frame is bf16.
template <Role kRole, typename Band, typename Frame>
struct Stage {
  static constexpr bool kS8 = std::is_same_v<Frame, int8_t>;
  static constexpr bool kWiden = kRole != Role::kRowMajor && std::is_same_v<Band, int8_t> && !kS8;
  static constexpr int kK = kWiden ? 64 : kRowBytes / sizeof(Band);  // senders: 32 f32, 64 bf16, 128 int8
  static constexpr int kSteps = kK / (kS8 ? 32 : 16);                 // wgmma k-steps of 16 (s8: 32) senders
  static constexpr int kFrames = std::is_same_v<Band, float> ? 3 : 1;
  static constexpr int kBandBytes = kWiden ? kBoxBytes : kTileR * kRowBytes;  // 8 or 16 KB
  static constexpr int kFrameBytes = kK * kTileF * (int)sizeof(Frame);  // one frame's rows: 4, 8 or 16 KB
  static constexpr int kBytes = kBandBytes + kFrames * kFrameBytes;
  static constexpr int kWideBytes = kWiden ? kConsumerGroups * 2 * kBoxBytes : 0;
  static constexpr int kStages = 6;
  static constexpr int kSmemBytes = kStages * kBytes + kWideBytes + kSwizzleAtom;
  static_assert(kBytes % kSwizzleAtom == 0 && kFrameBytes % kSwizzleAtom == 0,
                "stages and frames keep the 1024-byte swizzle alignment");
};

struct Params {
  const float* scales;  // [nb, D]: role B and the int8 band; null for role A's bf16 and f32 bands
  float* out;
  int nb, W;
  int b;       // the output's block: receivers stored per row block
  int b_pad;   // the block of the band and the frame the maps read
  int F;       // features stored
  int mtiles, ftiles;
  long long n;    // output nodes stored
  long long ldo;  // output stride of a node (role A) or a feature (role B), elements
  long long ldb;  // role B: output stride of a row block, elements
  int fblock;     // K4: senders of a node block in the frame's map (b, or b_pad for a padded copy)
  const float* xscales = nullptr;  // K5: [nb + 2W], one scale per frame block
  float* sink = nullptr;           // B3b: one float, the other chunks' sums
  int R = 1, i_star = 0;           // B3b: row blocks of a chunk, the chunk that stores
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

// The same from a 2-D tensor map (K4's xT); c0 may be negative or past the
// map's extent, which is zero fill.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma's shared-memory operands).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier over one consumer warpgroup's 128 threads (barrier 0 is
// __syncthreads).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + group) : "memory");
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
// Waits until no committed wgmma group of this warp is pending.
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

// D (+)= A * B, m64n64k32, s32 += s8 x s8, exact: A from registers, this
// thread's fragment of the 64 x 32 s8 A tile, a[0] = (row q, k 4t..4t+3),
// a[1] = (row q + 8, same k), a[2] = (row q, k 4t+16..4t+19), a[3] = (row q
// + 8, same k), for q = 16 * warp + lane / 4 and t = lane % 4, lower k in
// the lower byte; B K-major from shared memory (the 8-bit forms have no
// transposed operand).  `accumulate` 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The same fence for an s32 accumulator.
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
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

// An A fragment's pair as bf16x2: an f32 pair rounded, a bf16 pair as it is.
__device__ __forceinline__ uint32_t bf16x2(float2 v) { return pack_bf16x2(v.x, v.y); }
__device__ __forceinline__ uint32_t bf16x2(uint32_t v) { return v; }

// Two int8 values, bits 0-7 and 8-15 of v, times scale, as bf16x2: each
// byte, its sign bit flipped (q + 128), becomes the f32 2^23 + q + 128, from
// which one subtraction gives q exactly; then fl(q * scale) in f32, rounded
// to bf16 (B2c's fold with wrow_bf16: the plain version's two roundings).
__device__ __forceinline__ uint32_t fold2(uint32_t v, float scale) {
  const uint32_t u = v ^ 0x8080u;
  const float q0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float q1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  return pack_bf16x2(__fmul_rn(q0, scale), __fmul_rn(q1, scale));
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

// The sums of a unit from registers: fragment entry i is row 16 * warp +
// quad (+ 8 for i % 4 >= 2), column 8 * (i / 4) + pair (+ 1 for odd i); rows
// are receivers in role A, features in role B.  Role A stores node-major,
// out[node * ldo + f]; role B out[f * ldo + rb * ldb + r] (K4 and B3a: ldo
// the output's columns, ldb = b; K6: ldo = b, ldb = F * b).
template <Role kRole>
__device__ __forceinline__ void store_sums(const float (&acc)[32], const Params& p, int rb, int mt,
                                           int ft, int group, int warp, int quad, int pair) {
  const long long block0 = (long long)rb * p.b;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = 16 * warp + quad + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + pair;
    if constexpr (kRole == Role::kRowMajor) {
      const int r = mt * kTileR + kGroupR * group + row, f = ft * kTileF + col;
      const long long node = block0 + r;
      const bool row_ok = r < p.b && node < p.n;
      store2(p.out, node * p.ldo + f, row_ok && f < p.F, row_ok && f + 1 < p.F, acc[i], acc[i + 1]);
    } else {
      const int f = ft * kTileF + row, r = mt * kTileR + kGroupR * group + col;
      const long long node = block0 + r;
      const bool f_ok = f < p.F;
      store2(p.out, (long long)f * p.ldo + rb * p.ldb + r, f_ok && r < p.b && node < p.n,
             f_ok && r + 1 < p.b && node + 1 < p.n, acc[i], acc[i + 1]);
    }
  }
}

// K5's sums from registers, feature-major, out[f * ldo + rb * ldb + r]: its
// fragment's rows are receivers in the permuted order, entry i receiver 16
// * warp + 2 * quad + ((i >> 1) & 1) of the warpgroup's 64, column feature 8
// * (i / 4) + pair (+ 1 for odd i).  A thread's two receivers sit side by
// side, one 8-byte store a feature; a warp's store covers 16 receivers of
// each of 4 features, whole 32-byte sectors.
__device__ __forceinline__ void store_sums_s8(const float (&acc)[32], const Params& p, int rb, int mt, int ft,
                                              int group, int warp, int quad, int pair) {
  const int r = mt * kTileR + kGroupR * group + 16 * warp + 2 * quad;
  const long long node = (long long)rb * p.b + r;
  const bool ok0 = r < p.b && node < p.n, ok1 = r + 1 < p.b && node + 1 < p.n;
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int f = ft * kTileF + 8 * (i >> 2) + pair + e;
      if (f < p.F)
        store2(p.out, (long long)f * p.ldo + rb * p.ldb + r, ok0, ok1, acc[i + e], acc[i + 2 + e]);
    }
  }
}

template <Role kRole, typename Band, typename Frame, Fold kFold, Variant kVariant>
__global__ void __launch_bounds__(kThreads, 1)
    band_mma_kernel(__grid_constant__ const CUtensorMap band_map,
                    __grid_constant__ const CUtensorMap frame_map, const Params p) {
  using S = Stage<kRole, Band, Frame>;
  constexpr bool kRowMajor = kRole == Role::kRowMajor;
  constexpr bool kInt8 = std::is_same_v<Band, int8_t>;  // widened in registers (role A) or shared memory (role B)
  constexpr bool kF32 = std::is_same_v<Band, float>;    // split in registers
  constexpr bool kF32Frame = std::is_same_v<Frame, float>;  // rounded in registers (K4, K6)
  constexpr bool kXT = kRole == Role::kFeatureMajor && kF32Frame;  // K4: a 2-D map over xT
  constexpr bool kFoldBf16 = kFold == Fold::kIntoTileBf16;
  constexpr bool kScaledDot = (kInt8 && !kFoldBf16) || !kRowMajor;
  constexpr bool kPastBlock = kVariant == Variant::kPastBlock;
  constexpr bool kPanel = kVariant == Variant::kPanel;
  constexpr bool kDmaOnly = kVariant == Variant::kDmaOnly;
  static_assert(kRowMajor || kInt8 || std::is_same_v<Band, __nv_bfloat16>,
                "role B takes a bf16 or an int8 band");
  static_assert(kRole != Role::kBlocked || kInt8, "the blocked layout takes the int8 band");
  static_assert(std::is_same_v<Frame, __nv_bfloat16> || (S::kWiden && kF32Frame) ||
                    (S::kS8 && kInt8 && kRole != Role::kBlocked),
                "a bf16 frame, an f32 one for role B over the int8 band, or K5's and B2b's int8 one");
  static_assert(kInt8 || !kFoldBf16, "only an int8 band has a scale to fold");
  static_assert(kRowMajor || !kFoldBf16, "role B keeps the scale on the dot");
  static_assert(kXT || !kPastBlock, "only K4's 2-D map reads past the block");
  static_assert(!kPanel || (S::kWiden && kRole == Role::kFeatureMajor && !kF32Frame),
                "B3b's panel is role B's over the int8 band on a bf16 frame");
  static_assert(!kDmaOnly || (kRole == Role::kFeatureMajor && kInt8 && std::is_same_v<Frame, __nv_bfloat16>),
                "B3a dma-only is role B's feature-major launch over the int8 band on a bf16 frame");
  static_assert(!kDmaOnly || (S::kWiden && S::kK == 64 && S::kBytes == 16384 && S::kStages == 6),
                "B3a dma-only stages what B3d stages");
  __shared__ __align__(8) uint64_t full_bar[S::kStages];
  __shared__ __align__(8) uint64_t empty_bar[S::kStages];
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: stages start on that grid
  const uint32_t ring = (smem_u32(smem_raw) + kSwizzleAtom - 1) & ~(uint32_t)(kSwizzleAtom - 1);

  const int D = 2 * p.W + 1;
  const int nk = (p.b_pad + S::kK - 1) / S::kK;  // sender chunks of a tile
  const long long units = (long long)p.nb * p.mtiles * p.ftiles;
  const int group = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (group == kConsumerGroups) {
    // the producer: one thread keeps the ring full
    if (threadIdx.x != kConsumerGroups * 128) return;
    const uint64_t keep = l2_policy(true);
    // B3b re-reads its panel: it stays in L2 (evict_last) like the frame
    const uint64_t stream = kPanel ? keep : l2_policy(false);
    const int blocks = p.nb + 2 * p.W;  // frame blocks of one frame
    int stage = 0;
    uint32_t phase = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const int ft = (int)(u % p.ftiles);
      const int mt = (int)((u / p.ftiles) % p.mtiles);
      const int rb = (int)(u / ((long long)p.ftiles * p.mtiles));
      // the unit's band row and first frame block: its own, or B3b's panel
      // map for row r of chunk i: band row (r + i) mod R, frame block (r + d
      // + i) mod (R + 2W)
      int band_row = rb, blk0 = rb;
      if constexpr (kPanel) {
        const int chunk = rb / p.R, r = rb - chunk * p.R;
        band_row = (r + chunk) % p.R;
        blk0 = r + chunk;
      }
      for (int d = 0; d < D; ++d) {
        const int tile = band_row * D + d, blk = kPanel ? (blk0 + d) % (p.R + 2 * p.W) : blk0 + d;
        for (int kc = 0; kc < nk; ++kc) {
          const uint32_t full = smem_u32(&full_bar[stage]);
          mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1);
          mbar_expect_tx(full, S::kBytes);
          const uint32_t band = ring + stage * S::kBytes, frame = band + S::kBandBytes;
          const int s0 = kc * S::kK, r0 = mt * kTileR, f0 = ft * kTileF;
          if constexpr (kRowMajor) {
            // band box {kK senders, 128 receivers, 1 tile}; frame boxes {64
            // features, kK senders, 1 block}, one from each frame, or (B2b)
            // K5's int8 frame box {128 senders, 1 block, 64 features}
            tma_load(band, &band_map, full, s0, r0, tile, stream);
            if constexpr (S::kS8) {
              tma_load(frame, &frame_map, full, s0, blk, f0, keep);
            } else {
#pragma unroll
              for (int f = 0; f < S::kFrames; ++f)
                tma_load(frame + f * S::kFrameBytes, &frame_map, full, f0, s0, f * blocks + blk, keep);
            }
          } else if constexpr (S::kWiden || S::kS8) {
            // band box {128 receivers, 64 senders (K5: 128), 1 tile}
            tma_load(band, &band_map, full, r0, s0, tile, stream);
            if constexpr (kF32Frame) {
              // two f32 frame boxes {32 senders, 64 features}: K4's at sender
              // (rb + d - W) * fblock + s of its 2-D map over xT (below 0 or
              // past the map's extent is zero fill), K6's at sender s of
              // block rb + d
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if constexpr (kXT) {
                  tma_load_2d(frame + h * kBoxBytes, &frame_map, full,
                              (rb + d - p.W) * p.fblock + s0 + 32 * h, f0, keep);
                } else {
                  tma_load(frame + h * kBoxBytes, &frame_map, full, s0 + 32 * h, f0, blk, keep);
                }
              }
            } else if constexpr (kRole == Role::kBlocked) {
              // one bf16 frame box {64 senders, 64 features, 1 block} (B3d)
              tma_load(frame, &frame_map, full, s0, f0, blk, keep);
            } else {
              // one frame box {128 bytes of senders, 1 block, 64 features}:
              // bf16 (B3a's frame, B3b's window) or int8 (K5)
              tma_load(frame, &frame_map, full, s0, blk, f0, keep);
            }
          } else {
            // two band boxes {64 receivers, 64 senders, 1 tile}; frame box {64 senders, 1 block, 64 features}
#pragma unroll
            for (int c = 0; c < kTileR / 64; ++c)
              tma_load(band + c * kBoxBytes, &band_map, full, r0 + 64 * c, s0, tile, stream);
            tma_load(frame, &frame_map, full, s0, blk, f0, keep);
          }
          if (++stage == S::kStages) stage = 0, phase ^= 1;
        }
      }
    }
  } else if constexpr (S::kS8) {
    // the consumers of K5 and B2b: warpgroup `group` owns receivers [64 *
    // group, 64 * group + 64) of a unit, m64n64k32 s8 products of receivers
    // x features, exact in s32.  K5: the A fragment's rows are receivers in
    // a permuted order, row 16 * warp + quad receiver 16 * warp + 2 * quad
    // and row + 8 the next one, so one 16-bit load at a sender row of the
    // swizzled transposed tile (chunk 4 * group + warp ^ s % 8, byte 2 *
    // quad) serves both of a thread's rows.  Its senders 4t + e (+ 16) of a
    // k-group go in the order e = (i + t / 2) % 4: lanes t and t + 2 then
    // meet rows of different s % 8, so different chunks, and a warp's load
    // meets each bank once.  Two byte permutes a pair of loads, then one a
    // register, give the fragment: receiver 2 * quad's senders in `lo`, 2 *
    // quad + 1's in `hi`, sender 4t + e in byte e.  B2b: the fragment's rows
    // are receivers 16 * warp + quad and + 8 of the receiver-major box, as
    // K3 reads them, and each register one 32-bit load of four senders
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int quad = lane / 4, pair = 2 * (lane % 4), rot = (lane % 4) >> 1;
    const uint8_t* const ring_ptr = smem_raw + (ring - smem_u32(smem_raw));
    [[maybe_unused]] int s_off[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 2 * pair + ((i + rot) & 3);  // 4t + e
      s_off[i] = s * kRowBytes + (((4 * group + warp) ^ (s & 7)) << 4) + 2 * quad;
    }
    [[maybe_unused]] const uint32_t sel_lo = rot ? 0x4206u : 0x6420u, sel_hi = rot ? 0x5317u : 0x7531u;
    // B2b: the fragment's row in the stage's band box, at byte 4t of a chunk
    [[maybe_unused]] const int frag = (kGroupR * group + 16 * warp + quad) * kRowBytes + 2 * pair;
    int stage = 0;
    uint32_t phase = 0;
    float acc[32];
    int dot[32];
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const int ft = (int)(u % p.ftiles);
      const int mt = (int)((u / p.ftiles) % p.mtiles);
      const int rb = (int)(u / ((long long)p.ftiles * p.mtiles));
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      for (int d = 0; d < D; ++d) {
        // the tile's scale times its frame block's, read while its products run
        const float scale = __fmul_rn(__ldg(p.scales + (size_t)rb * D + d), __ldg(p.xscales + rb + d));
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(smem_u32(&full_bar[stage]), phase);
          const uint8_t* const rows = ring_ptr + stage * S::kBytes;
          const uint32_t frame = ring + stage * S::kBytes + S::kBandBytes;
          // the fragment's bytes of all k-steps: k-group h of k-step k is
          // senders 32k + 16h + 4t .. + 3
          [[maybe_unused]] uint32_t halves[S::kSteps][2][2];
          uint32_t a[S::kSteps][4];
          if constexpr (kRowMajor) {
            // B2b: register 2h (2h + 1: the row 8 on) of k-step k, one 32-bit
            // load of the row at chunk (2k + h) ^ quad
#pragma unroll
            for (int k = 0; k < S::kSteps; ++k)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int c = frag + (((2 * k + h) ^ quad) << 4);
                a[k][2 * h] = *reinterpret_cast<const uint32_t*>(rows + c);
                a[k][2 * h + 1] = *reinterpret_cast<const uint32_t*>(rows + 8 * kRowBytes + c);
              }
          } else {
            // K5: two receivers a 16-bit load
#pragma unroll
            for (int k = 0; k < S::kSteps; ++k)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                uint32_t v[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  v[i] = *reinterpret_cast<const uint16_t*>(rows + (32 * k + 16 * h) * kRowBytes + s_off[i]);
                halves[k][h][0] = __byte_perm(v[0], v[1], 0x5410);
                halves[k][h][1] = __byte_perm(v[2], v[3], 0x5410);
              }
          }
          fence_operands(dot);
#pragma unroll
          for (int k = 0; k < S::kSteps; ++k) {
            if constexpr (!kRowMajor) {
              // gathered outside any wgmma group: each k-step is a group of its own
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                a[k][2 * h] = __byte_perm(halves[k][h][0], halves[k][h][1], sel_lo);
                a[k][2 * h + 1] = __byte_perm(halves[k][h][0], halves[k][h][1], sel_hi);
              }
            }
            wgmma_fence();  // orders the fragment's registers before the product reads them
            // B: the frame box's rows (features) of 128 senders, K-major, k-step 32 bytes
            wgmma_m64n64k32_s8(dot, a[k], smem_desc(frame + k * 32, 0, 1024),
                               (kc | k) != 0);  // the tile's first k-step starts its dot
            wgmma_commit();
          }
          wgmma_wait_all();
          fence_fragments(a);
          fence_operands(dot);
          __syncwarp();
          if (lane == 0) mbar_arrive(smem_u32(&empty_bar[stage]));
          if (++stage == S::kStages) stage = 0, phase ^= 1;
        }
        // the tile's dot into the sum: exact in f32 (|dot| <= 127^2 * 256 <
        // 2^24), times the scale, then added, each rounding apart, the plain
        // version's order
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(scale, __int2float_rn(dot[i])));
      }
      if constexpr (kRowMajor) {
        store_sums<Role::kRowMajor>(acc, p, rb, mt, ft, group, warp, quad, pair);
      } else {
        store_sums_s8(acc, p, rb, mt, ft, group, warp, quad, pair);
      }
    }
  } else if constexpr (kDmaOnly) {
    // the consumers of B3a dma-only: warpgroup `group` keeps receivers [64 *
    // group, 64 * group + 64) of a unit by its 64 features in role B's
    // accumulator layout, entry 4j + 2h + e feature 16 * warp + quad + 8h by
    // receiver 8j + pair + e, and adds x and the band's tile row into it
    // from two stages of diagonal 0; every other stage is waited for and
    // released untouched.  Both boxes have 128-byte rows, a thread's rows
    // (features of the frame box, sender rows of the band box) are 16 *
    // warp + quad and + 8, and chunk c of a row sits at c ^ quad
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int quad = lane / 4, pair = 2 * (lane % 4);
    const uint8_t* const ring_ptr = smem_raw + (ring - smem_u32(smem_raw)) + (16 * warp + quad) * kRowBytes;
    int stage = 0;
    uint32_t phase = 0;
    float acc[32];
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const int ft = (int)(u % p.ftiles);
      const int mt = (int)((u / p.ftiles) % p.mtiles);
      const int rb = (int)(u / ((long long)p.ftiles * p.mtiles));
      // this warpgroup's receivers are frame block rb's senders of chunk
      // 2 mt + group; feature f's tile row is sender row f, in chunk ft
      const int x_chunk = 2 * mt + group;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      for (int d = 0; d < D; ++d) {
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(smem_u32(&full_bar[stage]), phase);
          const uint8_t* const st = ring_ptr + stage * S::kBytes;
          if (d == 0 && kc == x_chunk) {
            // x: the bf16 pair of senders 8j + pair, one 32-bit load at chunk j
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const uint32_t v = *reinterpret_cast<const uint32_t*>(st + S::kBandBytes + h * 8 * kRowBytes +
                                                                      ((j ^ quad) << 4) + 2 * pair);
                acc[4 * j + 2 * h] += __uint_as_float(v << 16);
                acc[4 * j + 2 * h + 1] += __uint_as_float(v & 0xFFFF0000u);
              }
          }
          if (d == 0 && kc == ft) {
            // the band: the int8 pair of receivers 64 group + 8j + pair, one
            // 16-bit load at chunk 4 group + j / 2, byte 8 (j % 2) + pair
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const char2 v = *reinterpret_cast<const char2*>(
                    st + h * 8 * kRowBytes + (((4 * group + (j >> 1)) ^ quad) << 4) + 8 * (j & 1) + pair);
                acc[4 * j + 2 * h] += (float)v.x;
                acc[4 * j + 2 * h + 1] += (float)v.y;
              }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(smem_u32(&empty_bar[stage]));
          if (++stage == S::kStages) stage = 0, phase ^= 1;
        }
      }
      store_sums<kRole>(acc, p, rb, mt, ft, group, warp, quad, pair);
    }
  } else if constexpr (S::kWiden) {
    // the consumers of role B over the int8 band: warpgroup `group` owns
    // receivers [64 * group, 64 * group + 64) of a unit, m64n64 products of
    // features x receivers.  Widening: thread t of the warpgroup takes the
    // group's 16-receiver chunk wj of sender rows ws and ws + 32 (one row %
    // 8); a quarter warp takes one chunk of eight consecutive rows, so its
    // 16-byte loads and stores meet each bank once
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int quad = lane / 4, pair = 2 * (lane % 4);
    const uint8_t* const ring_ptr = smem_raw + (ring - smem_u32(smem_raw));
    const int t = threadIdx.x % 128;
    const int wj = (t >> 3) & 3, ws = (t & 7) + 8 * (t >> 5), sw = ws & 7;
    const int in_off = ws * kRowBytes + (((4 * group + wj) ^ sw) << 4);  // int8 receivers 64 group + 16 wj ...
    const int lo_off = ws * kRowBytes + (((2 * wj) ^ sw) << 4);          // ... as bf16, the first 8
    const int hi_off = ws * kRowBytes + (((2 * wj + 1) ^ sw) << 4);      // and the next 8
    // this warpgroup's two bf16 boxes, after the ring
    const uint32_t wide = ring + S::kStages * S::kBytes + group * 2 * kBoxBytes;
    uint8_t* const wide_ptr = smem_raw + (wide - smem_u32(smem_raw));
    // the A fragment's pairs in a stage's frame, from its row 16 warp +
    // quad: senders 16 k + pair (+1) of k-step k (h = 0) and 8 on (h = 1),
    // each 16-byte chunk ^ quad (the row's % 8).  An f32 frame: box k / 2
    // of 32 senders, byte 64 (k % 2) + 32 h + 4 pair, a 64-bit load; a bf16
    // frame: one box of 64 senders, byte 32 k + 16 h + 2 pair, a 32-bit load
    int a_off[S::kSteps][2];
#pragma unroll
    for (int k = 0; k < S::kSteps; ++k)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a_off[k][h] = kF32Frame ? (k >> 1) * kBoxBytes + (((4 * (k & 1) + 2 * h + pair / 4) ^ quad) << 4) +
                                      4 * (pair % 4)
                                : (((2 * k + h) ^ quad) << 4) + 2 * pair;
    const int frag_row = (16 * warp + quad) * kRowBytes;
    using Pair = std::conditional_t<kF32Frame, float2, uint32_t>;
    int stage = 0, buf = 0;
    uint32_t phase = 0;
    float acc[32], dot[32];
    [[maybe_unused]] float sink = 0.f;  // B3b: the other chunks' sums
    uint32_t a[S::kSteps][4] = {};
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const int ft = (int)(u % p.ftiles);
      const int mt = (int)((u / p.ftiles) % p.mtiles);
      const int rb = (int)(u / ((long long)p.ftiles * p.mtiles));
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float scale = __ldg(p.scales + (size_t)rb * D + d);
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(smem_u32(&full_bar[stage]), phase);
          const uint8_t* const st = ring_ptr + stage * S::kBytes;
          uint8_t* const wb = wide_ptr + buf * kBoxBytes;
          // widening, while the last stage's products read the other
          // buffer; the products two stages back, which read this one, are
          // done (every thread of the warpgroup waited for them before the
          // last stage's barrier)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // 16 int8 receivers, widened exactly into two 16-byte bf16 chunks
            const uint4 v = *reinterpret_cast<const uint4*>(st + in_off + h * 32 * kRowBytes);
            *reinterpret_cast<uint4*>(wb + lo_off + h * 32 * kRowBytes) =
                make_uint4(widen2(v.x), widen2(v.x >> 16), widen2(v.y), widen2(v.y >> 16));
            *reinterpret_cast<uint4*>(wb + hi_off + h * 32 * kRowBytes) =
                make_uint4(widen2(v.z), widen2(v.z >> 16), widen2(v.w), widen2(v.w >> 16));
          }
          // the A fragment's pairs of all k-steps, loaded while they run too
          const uint8_t* const frame = st + S::kBandBytes + frag_row;
          Pair x[S::kSteps][4];
#pragma unroll
          for (int k = 0; k < S::kSteps; ++k) {
            const int c0 = a_off[k][0], c1 = a_off[k][1];
            x[k][0] = *reinterpret_cast<const Pair*>(frame + c0);
            x[k][1] = *reinterpret_cast<const Pair*>(frame + 8 * kRowBytes + c0);
            x[k][2] = *reinterpret_cast<const Pair*>(frame + c1);
            x[k][3] = *reinterpret_cast<const Pair*>(frame + 8 * kRowBytes + c1);
          }
          // the last stage's products read the fragment registers: let them
          // finish, then put the pairs into them (an f32 frame rounded)
          wgmma_wait_all();
          fence_fragments(a);
          if (kPastBlock && kc == nk - 1) {
            // K4 where b_pad is not a multiple of 64: its 2-D map reads the
            // tile's last stage on past the block, into the next node
            // blocks' x, which meets band rows of zero fill.  Those k-steps
            // are set to zero, so a non-finite x there cannot enter (0 * Inf
            // is NaN)
#pragma unroll
            for (int k = 0; k < S::kSteps; ++k)
#pragma unroll
              for (int j = 0; j < 4; ++j) a[k][j] = kc * S::kK + 16 * k < p.b_pad ? bf16x2(x[k][j]) : 0u;
          } else {
#pragma unroll
            for (int k = 0; k < S::kSteps; ++k)
#pragma unroll
              for (int j = 0; j < 4; ++j) a[k][j] = bf16x2(x[k][j]);
          }
          // nothing reads the stage again: it goes back before the products run
          __syncwarp();
          if (lane == 0) mbar_arrive(smem_u32(&empty_bar[stage]));
          // the widened box was written through the generic proxy and wgmma
          // reads it through the async proxy: each thread fences its stores,
          // then the warpgroup meets, so all its stores are in before any
          // product
          fence_proxy_async();
          group_sync(group);
          fence_operands(dot);
          wgmma_fence();  // orders the fragment's registers before the products read them
          const uint32_t wbox = wide + buf * kBoxBytes;
#pragma unroll
          for (int k = 0; k < S::kSteps; ++k)
            // B: the widened box's rows (senders) of 64 receivers, MN-major, k-step 16 rows
            wgmma_m64n64_rs(dot, a[k], smem_desc(wbox + k * 16 * kRowBytes, kBoxBytes, 1024),
                            (kc | k) != 0);  // the tile's first k-step starts its dot
          wgmma_commit();
          if (++stage == S::kStages) stage = 0, phase ^= 1;
          buf ^= 1;
        }
        // the tile's dot into the sum, times its scale, once its last
        // stage's products are done: after the stage loop, where every
        // thread waits, not under a test of the tile's last stage (there
        // ptxas serialized every wgmma of role B, C7518)
        wgmma_wait_all();
        fence_fragments(a);
        fence_operands(dot);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += scale * dot[i];
      }
      if constexpr (kPanel) {
        // B3b: chunk i* stores its panel at its local row; every other
        // chunk's sums fold into the sink, so no chunk's arithmetic can be
        // dropped
        const int chunk = rb / p.R;
        if (chunk == p.i_star) {
          store_sums<kRole>(acc, p, rb - chunk * p.R, mt, ft, group, warp, quad, pair);
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) sink += acc[i];
        }
      } else {
        store_sums<kRole>(acc, p, rb, mt, ft, group, warp, quad, pair);
      }
    }
    if constexpr (kPanel) {
      // one warp sum and one atomic a warp, after its last unit
      for (int off = 16; off > 0; off >>= 1) sink += __shfl_xor_sync(0xffffffffu, sink, off);
      if (lane == 0) atomicAdd(p.sink, sink);
    }
  } else {
    // the consumers: warpgroup `group` owns receivers [64 * group, 64 * group + 64)
    // of a unit, m64n64 products: receivers x features in role A, features
    // x receivers in role B
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int quad = lane / 4, pair = 2 * (lane % 4);
    // an int8 or f32 band's A fragment: this thread's receivers 16 * warp +
    // quad and + 8 of its warpgroup's 64, rows of the stage's band box read
    // directly
    const uint8_t* const ring_ptr = smem_raw + (ring - smem_u32(smem_raw));
    const int frag_row = (kGroupR * group + 16 * warp + quad) * kRowBytes;
    int stage = 0;
    uint32_t phase = 0;
    // the sum, the tile's dot, and (f32 band) the unit's five small products
    float acc[32], dot[32], corr[kF32 ? 32 : 1];
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const int ft = (int)(u % p.ftiles);
      const int mt = (int)((u / p.ftiles) % p.mtiles);
      const int rb = (int)(u / ((long long)p.ftiles * p.mtiles));
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      for (int d = 0; d < D; ++d) {
        // the tile's scale, read while its products run: on the dot, or
        // folded into the tile (a bf16 or f32 band in role A has none)
        const float scale = kInt8 || !kRowMajor ? __ldg(p.scales + (size_t)rb * D + d) : 1.f;
        const float dot_scale = kScaledDot ? scale : 1.f;
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(smem_u32(&full_bar[stage]), phase);
          const uint32_t band = ring + stage * S::kBytes, frame = band + S::kBandBytes;
          if constexpr (kInt8) {
            // the fragment's bytes of all k-steps, 16-bit loads at chunk k ^ quad
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
              for (int j = 0; j < 4; ++j) a[k][j] = kFoldBf16 ? fold2(raw[k][j], scale) : widen2(raw[k][j]);
              wgmma_fence();  // orders the fragment's registers before the product reads them
              // B: frame rows (senders) of 64 features, MN-major, k-step 16 rows
              wgmma_m64n64_rs(dot, a[k], smem_desc(frame + k * 16 * kRowBytes, kBoxBytes, 1024),
                              (kc | k) != 0);  // the tile's first k-step starts its dot
              wgmma_commit();
            }
            wgmma_wait_all();
            fence_fragments(a);
          } else if constexpr (kF32) {
            // the fragment's f32 pairs, 64-bit loads: senders 16k + pair (+1)
            // are at byte 64k + 4 * pair, chunk 4k + pair / 4, and + 8
            // senders two chunks on; split into hi, mid and lo
            const uint8_t* const rows = ring_ptr + stage * S::kBytes + frag_row;
            uint32_t a[3 * S::kSteps][4];
            fence_operands(dot);
            fence_operands(corr);
#pragma unroll
            for (int k = 0; k < S::kSteps; ++k) {
              const int c0 = (((4 * k + pair / 4) ^ quad) << 4) + 4 * (pair % 4);
              const int c1 = (((4 * k + 2 + pair / 4) ^ quad) << 4) + 4 * (pair % 4);
              const float2 v[4] = {*reinterpret_cast<const float2*>(rows + c0),
                                   *reinterpret_cast<const float2*>(rows + 8 * kRowBytes + c0),
                                   *reinterpret_cast<const float2*>(rows + c1),
                                   *reinterpret_cast<const float2*>(rows + 8 * kRowBytes + c1)};
#pragma unroll
              for (int j = 0; j < 4; ++j) split3(v[j], a[3 * k][j], a[3 * k + 1][j], a[3 * k + 2][j]);
              wgmma_fence();
              // B: the three frames' rows of this k-step, hi, mid, lo
              const uint32_t fk = frame + k * 16 * kRowBytes;
              const uint64_t xhi = smem_desc(fk, kBoxBytes, 1024);
              const uint64_t xmid = smem_desc(fk + S::kFrameBytes, kBoxBytes, 1024);
              const uint64_t xlo = smem_desc(fk + 2 * S::kFrameBytes, kBoxBytes, 1024);
              const uint32_t(&hi)[4] = a[3 * k], (&mid)[4] = a[3 * k + 1], (&lo)[4] = a[3 * k + 2];
              // small terms first; the unit's first k-step starts `corr`
              wgmma_m64n64_rs(corr, lo, xhi, (d | kc | k) != 0);
              wgmma_m64n64_rs(corr, mid, xmid, 1);
              wgmma_m64n64_rs(corr, hi, xlo, 1);
              wgmma_m64n64_rs(corr, mid, xhi, 1);
              wgmma_m64n64_rs(corr, hi, xmid, 1);
              wgmma_m64n64_rs(dot, hi, xhi, (kc | k) != 0);  // the tile's first k-step starts its dot
              wgmma_commit();
            }
            wgmma_wait_all();
            fence_fragments(a);
            fence_operands(corr);
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
          if (++stage == S::kStages) stage = 0, phase ^= 1;
        }
        // the tile's dot into the sum
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += dot_scale * dot[i];
      }
      if constexpr (kF32) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += corr[i];
      }
      store_sums<kRole>(acc, p, rb, mt, ft, group, warp, quad, pair);
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

// A tensor map of rank 2 or 3 over f32, bf16 or int8 elements (the int8
// band is mapped as bytes; the zero fill is int8 0): dims innermost first,
// the strides of dims 1 (and 2) in bytes, a box of box[i] elements, 128-byte
// swizzle, zero fill.
template <typename T>
bool tensor_map(CUtensorMap* map, const T* base, int rank, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  static_assert(std::is_same_v<T, float> || std::is_same_v<T, __nv_bfloat16> ||
                    std::is_same_v<T, int8_t>,
                "f32, bf16 or int8");
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapDataType type = sizeof(T) == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                    : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return encode(map, type, (cuuint32_t)rank, const_cast<T*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D tensor map of a contiguous [d2, d1, d0] array.
template <typename T>
bool tensor_map(CUtensorMap* map, const T* base, uint64_t d0, uint64_t d1, uint64_t d2,
                uint32_t box0, uint32_t box1, uint32_t box2) {
  const cuuint64_t dims[3] = {d0, d1, d2}, strides[2] = {d0 * sizeof(T), d0 * d1 * sizeof(T)};
  const cuuint32_t box[3] = {box0, box1, box2};
  return tensor_map(map, base, 3, dims, strides, box);
}

bool valid(int nb, int W, int b, int b_pad, int F) {
  return nb > 0 && W >= 0 && b > 0 && b <= b_pad && b_pad % 16 == 0 && F > 0 &&
         (long long)nb * (2 * W + 1) < 0x7fffffffLL;
}

template <Role kRole, typename Band, typename Frame = __nv_bfloat16, Fold kFold = Fold::kOnDot,
          Variant kVariant = Variant::kPlain>
int launch(const CUtensorMap& band_map, const CUtensorMap& frame_map, Params p, void* stream) {
  p.mtiles = (p.b_pad + kTileR - 1) / kTileR;
  const long long units = (long long)p.nb * p.mtiles * p.ftiles;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  auto kernel = band_mma_kernel<kRole, Band, Frame, kFold, kVariant>;
  constexpr int smem = Stage<kRole, Band, Frame>::kSmemBytes;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)(units < sms ? units : sms);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(band_map, frame_map, p);
  return (int)cudaGetLastError();
}

// Role A over a bf16 band (scales null), an f32 band (scales null; frame
// holds its three frames) or an int8 band with its scales.
template <typename Band, Fold kFold = Fold::kOnDot>
int launch_rowmajor(const Band* band, const float* scales, const __nv_bfloat16* frame, float* out,
                    int nb, int W, int block, int block_pad, int F, int F_pad, int num_nodes,
                    void* stream) {
  if (!valid(nb, W, block, block_pad, F) || F_pad < F || F_pad % 8 != 0 || num_nodes <= 0 ||
      num_nodes > (long long)nb * block || (std::is_same_v<Band, int8_t> && scales == nullptr))
    return (int)cudaErrorInvalidValue;
  using S = Stage<Role::kRowMajor, Band, __nv_bfloat16>;
  const uint64_t bp = block_pad, D = 2 * W + 1, blocks = (uint64_t)nb + 2 * W;
  CUtensorMap band_map, frame_map;
  if (!tensor_map(&band_map, band, bp, bp, (uint64_t)nb * D, S::kK, kTileR, 1) ||
      !tensor_map(&frame_map, frame, (uint64_t)F_pad, bp, S::kFrames * blocks, kTileF, S::kK, 1))
    return (int)cudaErrorInvalidValue;
  Params p{scales, out, nb, W, block, block_pad, F, 0, (F_pad + kTileF - 1) / kTileF, num_nodes, F, 0, 0};
  return launch<Role::kRowMajor, Band, __nv_bfloat16, kFold>(band_map, frame_map, p, stream);
}

// B2b: role A over the int8 band (receiver-major tiles) with its scales,
// on K5's int8 frame xq [F, (nb + 2W) * block_pad] with one scale a frame
// block in xscales [nb + 2W]; out [num_nodes, F], node-major.
int launch_rowmajor_w8a8(const int8_t* band_q, const float* scales, const int8_t* xq, const float* xscales,
                         float* out, int nb, int W, int block, int block_pad, int F, int num_nodes,
                         void* stream) {
  if (!valid(nb, W, block, block_pad, F) || scales == nullptr || xscales == nullptr || num_nodes <= 0 ||
      num_nodes > (long long)nb * block)
    return (int)cudaErrorInvalidValue;
  using S = Stage<Role::kRowMajor, int8_t, int8_t>;
  static_assert(S::kS8 && S::kK == 128 && S::kSteps == 4 && S::kBandBytes == 16384 &&
                    S::kFrameBytes == 8192 && S::kBytes == 24576 && S::kStages == 6 &&
                    S::kSmemBytes == Stage<Role::kFeatureMajor, int8_t, int8_t>::kSmemBytes,
                "B2b stages what K5 stages");
  const uint64_t bp = block_pad, D = 2 * W + 1, blocks = (uint64_t)nb + 2 * W;
  // role A's band box {128 senders, 128 receivers, 1 tile}; K5's frame box
  // {128 senders, 1 block, 64 features}
  CUtensorMap band_map, frame_map;
  if (!tensor_map(&band_map, band_q, bp, bp, (uint64_t)nb * D, S::kK, kTileR, 1) ||
      !tensor_map(&frame_map, xq, bp, blocks, (uint64_t)F, S::kK, 1, kTileF))
    return (int)cudaErrorInvalidValue;
  Params p{scales, out, nb, W, block, block_pad, F, 0, (F + kTileF - 1) / kTileF, num_nodes, F, 0, 0};
  p.xscales = xscales;
  return launch<Role::kRowMajor, int8_t, int8_t>(band_map, frame_map, p, stream);
}

// Role B's layout, feature-major, on a frame x_pad [F, (nb + 2W) *
// block_pad] in the W-shifted padded frame: bf16 over a bf16 band (B3a, two
// 64-receiver band boxes a stage) or the int8 band (B3c's bf16 route, one
// 128-receiver box, widened; B3a dma-only, no scales, F <= block); int8,
// with one scale a frame block in xscales [nb + 2W], over the int8 band
// (K5, s8 products).
template <typename Band, typename Frame, Variant kVariant = Variant::kPlain>
int launch_fm_frame(const Band* band_T, const float* scales, const Frame* x_pad, const float* xscales,
                    float* outT, int nb, int W, int block, int block_pad, int F, long long ldo,
                    long long num_cols, void* stream) {
  using S = Stage<Role::kFeatureMajor, Band, Frame>;
  constexpr bool kDmaOnly = kVariant == Variant::kDmaOnly;
  if (!valid(nb, W, block, block_pad, F) || (!kDmaOnly && scales == nullptr) || (kDmaOnly && F > block) ||
      num_cols <= 0 || num_cols > (long long)nb * block || ldo < num_cols || (S::kS8 && xscales == nullptr))
    return (int)cudaErrorInvalidValue;
  const uint64_t bp = block_pad, D = 2 * W + 1, blocks = (uint64_t)nb + 2 * W;
  // band boxes of 128-byte rows: {128 int8 or 64 bf16 receivers, kK senders, 1 tile}
  CUtensorMap band_map, frame_map;
  if (!tensor_map(&band_map, band_T, bp, bp, (uint64_t)nb * D, kRowBytes / (int)sizeof(Band), S::kK, 1) ||
      !tensor_map(&frame_map, x_pad, bp, blocks, (uint64_t)F, S::kK, 1, kTileF))
    return (int)cudaErrorInvalidValue;
  Params p{scales, outT, nb, W, block, block_pad, F, 0, (F + kTileF - 1) / kTileF, num_cols, ldo, block, 0};
  p.xscales = xscales;
  return launch<Role::kFeatureMajor, Band, Frame, Fold::kOnDot, kVariant>(band_map, frame_map, p, stream);
}

// Role B over the int8 band, blocked, on the frame xb_pad [nb + 2W, F,
// block_pad], f32 (K6) or bf16 (B3d).
template <typename Frame>
int launch_blocked(const int8_t* band_qT, const float* scales, const Frame* xb_pad, float* out, int nb,
                   int W, int block, int block_pad, int F, void* stream) {
  if (!valid(nb, W, block, block_pad, F) || scales == nullptr ||
      (long long)nb * block > 0x7fffffffLL || reinterpret_cast<uintptr_t>(xb_pad) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  using S = Stage<Role::kBlocked, int8_t, Frame>;
  const uint64_t bp = block_pad, D = 2 * W + 1, blocks = (uint64_t)nb + 2 * W;
  CUtensorMap band_map, frame_map;
  // frame boxes of 128-byte rows: {32 f32 or 64 bf16 senders, 64 features, 1 block}
  if (!tensor_map(&band_map, band_qT, bp, bp, (uint64_t)nb * D, kTileR, S::kK, 1) ||
      !tensor_map(&frame_map, xb_pad, bp, (uint64_t)F, blocks, kRowBytes / (int)sizeof(Frame), kTileF, 1))
    return (int)cudaErrorInvalidValue;
  Params p{scales, out, nb, W, block, block_pad, F, 0, (F + kTileF - 1) / kTileF,
           (long long)nb * block, block, (long long)F * block, 0};
  return launch<Role::kBlocked, int8_t, Frame>(band_map, frame_map, p, stream);
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

// B2c banded_spmm_quant_fused_dot: operands as for K3.  With wrow_bf16 each
// tile entry is folded to bf16(fl(q * scale)) as it is widened; without, the
// scale goes on the tile's dot, K3's order.
int cgt_banded_spmm_quant_fused_dot(const int8_t* band_q, const float* scales,
                                    const __nv_bfloat16* frame, float* out, int nb, int W,
                                    int block, int block_pad, int F, int F_pad, int num_nodes,
                                    int wrow_bf16, void* stream) {
  return wrow_bf16 ? launch_rowmajor<int8_t, Fold::kIntoTileBf16>(band_q, scales, frame, out, nb, W,
                                                                  block, block_pad, F, F_pad,
                                                                  num_nodes, stream)
                   : launch_rowmajor(band_q, scales, frame, out, nb, W, block, block_pad, F, F_pad,
                                     num_nodes, stream);
}

// K7 over a bf16 band, and B2a: band [nb, 2W+1, block_pad, block_pad] bf16
// (receiver-major tiles, zero past block); frame and out as for K3.
int cgt_banded_spmm_direct_bf16(const __nv_bfloat16* band, const __nv_bfloat16* frame, float* out,
                                int nb, int W, int block, int block_pad, int F, int F_pad,
                                int num_nodes, void* stream) {
  return launch_rowmajor(band, static_cast<const float*>(nullptr), frame, out, nb, W, block,
                         block_pad, F, F_pad, num_nodes, stream);
}

// K7 over an f32 band: band [nb, 2W+1, block_pad, block_pad] float32
// (receiver-major tiles, zero past block); frames [3, nb + 2W, block_pad,
// F_pad] bf16, x split exactly into hi, mid and lo (x == hi + mid + lo) in
// the W-shifted padded frame; out as for K3.
int cgt_banded_spmm_direct_f32(const float* band, const __nv_bfloat16* frames, float* out, int nb,
                               int W, int block, int block_pad, int F, int F_pad, int num_nodes,
                               void* stream) {
  return launch_rowmajor(band, static_cast<const float*>(nullptr), frames, out, nb, W, block,
                         block_pad, F, F_pad, num_nodes, stream);
}

// B2b banded_spmm_w8a8: band_q [nb, 2W+1, block_pad, block_pad] int8
// (receiver-major tiles, zero past block) with scales [nb, 2W+1]; xq [F,
// (nb + 2W) * block_pad] int8, x quantized per frame block in the W-shifted
// padded frame (zero past block), with xscales [nb + 2W]: K5's frame; out
// [num_nodes, F] float32, node rb * block + r.
int cgt_banded_spmm_w8a8_rowmajor(const int8_t* band_q, const float* scales, const int8_t* xq,
                                  const float* xscales, float* out, int nb, int W, int block,
                                  int block_pad, int F, int num_nodes, void* stream) {
  return launch_rowmajor_w8a8(band_q, scales, xq, xscales, out, nb, W, block, block_pad, F, num_nodes,
                              stream);
}

// B3a fm_bf16_band: band_T [nb, 2W+1, block_pad, block_pad] bf16
// (transposed tiles, zero past block) with scales [nb, 2W+1]; x_pad [F,
// (nb + 2W) * block_pad] bf16 in the W-shifted padded frame; outT [F, ldo]
// float32, column rb * block + r for the first num_cols columns.
int cgt_fm_bf16_band(const __nv_bfloat16* band_T, const float* scales, const __nv_bfloat16* x_pad,
                     float* outT, int nb, int W, int block, int block_pad, int F, long long ldo,
                     long long num_cols, void* stream) {
  return launch_fm_frame(band_T, scales, x_pad, static_cast<const float*>(nullptr), outT, nb, W, block,
                         block_pad, F, ldo, num_cols, stream);
}

// K4's function (B3c's) on the bf16 frame: band_qT [nb, 2W+1, block_pad,
// block_pad] int8 (transposed tiles, zero past block) with scales [nb,
// 2W+1]; x_pad and outT as for B3a.  No entry point of the port calls it:
// chip_smoke.py times it against K4's launch, B3c's route.
int cgt_banded_spmm_quant_fm_bf16(const int8_t* band_qT, const float* scales,
                                  const __nv_bfloat16* x_pad, float* outT, int nb, int W, int block,
                                  int block_pad, int F, long long ldo, long long num_cols, void* stream) {
  return launch_fm_frame(band_qT, scales, x_pad, static_cast<const float*>(nullptr), outT, nb, W, block,
                         block_pad, F, ldo, num_cols, stream);
}

// B3a fm_dma_only, the staging probe: band_qT [nb, 2W+1, block_pad,
// block_pad] int8 (transposed tiles, zero past block); x_pad [F, (nb + 2W)
// * block_pad] bf16 in the W-shifted padded frame, F <= block; every stage
// of role B over them is staged, and outT [F, ldo] float32 gets, at column
// j = rb * block + c for the first num_cols columns, x_pad[f, rb *
// block_pad + c] + band_qT[rb, 0][f, c].
int cgt_fm_dma_only(const int8_t* band_qT, const __nv_bfloat16* x_pad, float* outT, int nb, int W, int block,
                    int block_pad, int F, long long ldo, long long num_cols, void* stream) {
  return launch_fm_frame<int8_t, __nv_bfloat16, Variant::kDmaOnly>(
      band_qT, static_cast<const float*>(nullptr), x_pad, static_cast<const float*>(nullptr), outT, nb, W,
      block, block_pad, F, ldo, num_cols, stream);
}

// K5 banded_spmm_quant_fm_w8a8: band_qT [nb, 2W+1, block_pad, block_pad]
// int8 (transposed tiles, zero past block) with scales [nb, 2W+1]; xq [F,
// (nb + 2W) * block_pad] int8, x quantized per frame block in the W-shifted
// padded frame (zero past block), with xscales [nb + 2W]; outT [F,
// num_nodes] float32, column rb * block + r.
int cgt_banded_spmm_quant_fm_w8a8(const int8_t* band_qT, const float* scales, const int8_t* xq,
                                  const float* xscales, float* outT, int nb, int W, int block,
                                  int block_pad, int F, int num_nodes, void* stream) {
  return launch_fm_frame(band_qT, scales, xq, xscales, outT, nb, W, block, block_pad, F, num_nodes,
                         num_nodes, stream);
}

// B3b fm_compute_only: role B over the panel band_qT [R, 2W+1, block_pad,
// block_pad] int8 (band rows 0..R-1, transposed tiles, zero past block) with
// the scales of all nb row blocks [nb, 2W+1]; x_win [F, (R + 2W) *
// block_pad] bf16 (window 0 of the padded frame, zero past block); out [F,
// R * block] float32, chunk i*'s panel; sink one float, which the caller
// zeroes, gets every other chunk's sums.
int cgt_fm_compute_only(const int8_t* band_qT, const float* scales, const __nv_bfloat16* x_win,
                        float* out, float* sink, int nb, int W, int block, int block_pad, int F, int R,
                        void* stream) {
  if (!valid(nb, W, block, block_pad, F) || scales == nullptr || sink == nullptr || R <= 0 || nb % R != 0)
    return (int)cudaErrorInvalidValue;
  using S = Stage<Role::kFeatureMajor, int8_t, __nv_bfloat16>;
  const uint64_t bp = block_pad, D = 2 * W + 1, blocks = (uint64_t)R + 2 * W;
  CUtensorMap band_map, frame_map;
  if (!tensor_map(&band_map, band_qT, bp, bp, (uint64_t)R * D, kTileR, S::kK, 1) ||
      !tensor_map(&frame_map, x_win, bp, blocks, (uint64_t)F, S::kK, 1, kTileF))
    return (int)cudaErrorInvalidValue;
  const long long cols = (long long)R * block;
  Params p{scales, out, nb, W, block, block_pad, F, 0, (F + kTileF - 1) / kTileF, cols, cols, block, 0};
  p.sink = sink;
  p.R = R;
  p.i_star = (nb / R - 1) / 2 * 2;  // the largest even chunk: the TPU kernel's slots alternate
  return launch<Role::kFeatureMajor, int8_t, __nv_bfloat16, Fold::kOnDot, Variant::kPanel>(band_map, frame_map,
                                                                                          p, stream);
}

// K4 banded_spmm_quant_fm, and its backward launch over the transposed
// band: band_qT [nb, 2W+1, block_pad, block_pad] int8 (transposed tiles,
// zero past block) with scales [nb, 2W+1]; xT f32, row f at xT + f * ldx,
// sender v of node block j at column j * x_block + v for the first x_cols
// columns (the caller's xT with x_block = block and x_cols = num_nodes, or a
// padded copy); outT [F, num_nodes] float32, column rb * block + r.
int cgt_banded_spmm_quant_fm(const int8_t* band_qT, const float* scales, const float* xT, float* outT,
                             int nb, int W, int block, int block_pad, int F, int num_nodes,
                             int x_block, long long x_cols, long long ldx, void* stream) {
  if (!valid(nb, W, block, block_pad, F) || scales == nullptr || num_nodes <= 0 ||
      num_nodes > (long long)nb * block || x_block < block || x_cols <= 0 || ldx < x_cols ||
      ldx % 4 != 0 || reinterpret_cast<uintptr_t>(xT) % 16 != 0 ||
      (long long)(nb + W) * x_block + block_pad > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  using S = Stage<Role::kFeatureMajor, int8_t, float>;
  const uint64_t bp = block_pad, D = 2 * W + 1;
  const cuuint64_t dims[2] = {(cuuint64_t)x_cols, (cuuint64_t)F}, strides[1] = {(cuuint64_t)ldx * 4};
  const cuuint32_t box[2] = {32, kTileF};
  CUtensorMap band_map, frame_map;
  if (!tensor_map(&band_map, band_qT, bp, bp, (uint64_t)nb * D, kTileR, S::kK, 1) ||
      !tensor_map(&frame_map, xT, 2, dims, strides, box))
    return (int)cudaErrorInvalidValue;
  Params p{scales, outT, nb, W, block, block_pad, F, 0, (F + kTileF - 1) / kTileF, num_nodes,
           num_nodes, block, x_block};
  // a block that is not a multiple of a stage's 64 senders takes the
  // instantiation that masks the reads past it; the main shape's does not
  return block_pad % S::kK != 0
             ? launch<Role::kFeatureMajor, int8_t, float, Fold::kOnDot, Variant::kPastBlock>(band_map, frame_map,
                                                                                              p, stream)
             : launch<Role::kFeatureMajor, int8_t, float>(band_map, frame_map, p, stream);
}

// K6 banded_spmm_quant_blocked: band_qT and scales as for K4; xb_pad [nb +
// 2W, F, block_pad] float32, the W-shifted padded frame, blocked (zero past
// block); out [nb, F, block] float32.  Every receiver of the frame is
// stored and no sender is masked.
int cgt_banded_spmm_quant_blocked(const int8_t* band_qT, const float* scales, const float* xb_pad,
                                  float* out, int nb, int W, int block, int block_pad, int F,
                                  void* stream) {
  return launch_blocked(band_qT, scales, xb_pad, out, nb, W, block, block_pad, F, stream);
}

// B3d fm_blocked, K6's function on a bf16 frame: band_qT and scales as for
// K4; xb_pad [nb + 2W, F, block_pad] bf16 (zero past block); out as for K6.
int cgt_banded_spmm_quant_blocked_bf16(const int8_t* band_qT, const float* scales,
                                       const __nv_bfloat16* xb_pad, float* out, int nb, int W,
                                       int block, int block_pad, int F, void* stream) {
  return launch_blocked(band_qT, scales, xb_pad, out, nb, W, block, block_pad, F, stream);
}

}  // extern "C"
