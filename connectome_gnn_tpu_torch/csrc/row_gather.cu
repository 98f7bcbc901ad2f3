// Random-row gather B1 for NVIDIA Hopper (built for sm_90a):
// out[i, :] = table[idx[i], :] for a table [N, F] of any element type and
// int32 indices [L], a byte copy of each row; an index outside [0, N) traps.
//
// Replaces the Pallas TPU kernel dma_gather of
// benchmarks/gather_dma_experiments.py:52-111 (pallas_call at :91), which
// walks chunks of C indices held in SMEM and keeps K single-row HBM->VMEM
// DMAs in flight over a sliding window of K semaphores.  K and C change no
// value; neither does anything here: every output row is one row's bytes.
//
// What bounds it on this card.  It is pure data movement.  Its least time
// counts the touched rows read once, the output written once and the
// indices read once, over 3.35 TB/s.  At the script's three cases
// (gather_dma_experiments.py:245-252) that is 0.346 ms for (a), 4,194,304
// rows of 256 B from a 67.1 MB table (the output alone is 1.07 GB, 0.32
// ms); 18 us for (b'), 131,072 such rows; under a microsecond for (b),
// 131,072 rows of 8 B from a 33.6 MB table, below any launch.  That bound
// assumes the table stays in L2 while the output streams past.  It does
// not: at the first case's 4M indices the launch takes 0.410 ms from a
// 4.2 MB table, 0.518 from 16.8 MB, 0.607 from 33.6, 0.647 from 50.3 and
// 0.668 from 67.1 (chip_smoke.py phase 25, "[25 gather L2]"; H100 80GB
// HBM3, 700 W).  Rows miss L2 well below its 50 MB, and the misses, not the
// way the rows are copied, set the time: the extra time over the 4.2 MB
// table is what reading two thirds or more of the gathered bytes from HBM
// takes.  L2 eviction hints (createpolicy evict_last on the table,
// evict_first on the output, or half the table kept) changed none of these
// times by more than noise at any of those table sizes, so the kernel
// gives none.
//
// Two designs were measured against each other at the script's cases (the
// launch alone, CUDA events, in turns, one H100 80GB HBM3 at 700 W):
//   * rows moved by TMA: persistent blocks whose producer warp issued one
//     cp.async.bulk a row (a lane a row, evict_last) into an mbarrier ring
//     of shared memory, and one thread storing each full stage's slab of
//     the output by cp.async.bulk (evict_first).  It copies without
//     registers, but an SM completed such 256-B copies no faster than one
//     every 16-22 ns with several blocks on it, and one every 39 ns with
//     one: 0.695 ms at (a), 0.0425 ms at (b') with C = 1024 (128 blocks),
//     against 0.652 and 0.0283 for the register body at 256 threads a
//     block; from an L2-resident table it was 10 % slower at 256-B rows,
//     even at 1-4 KB rows, and ahead only at 16 KB rows.  It was removed;
//   * this kernel: vector loads into registers, then stores.  Made
//     persistent, or given the L2 hints above, it was no faster.
//
// The design.
//   * One thread block per chunk of C indices.  It copies its chunk's
//     indices into shared memory itself (the SMEM index block; a block loads
//     its own indices) and masks the ragged last chunk: C need not divide L,
//     where the TPU kernel cut C to a divisor of L.
//   * Rows are copied in vector words of V bytes, the widest of 16, 8, 4, 2
//     and 1 that divides the row's bytes and both base addresses (the
//     wrapper picks V): a 256-B row is 16 lanes of 16 B, so one warp moves
//     two rows per instruction; an 8-B int32 pair is one lane a row.  The
//     chunk's (row, word) items are numbered row-major, so neighbouring
//     threads read neighbouring words of a row and write neighbouring words
//     of the output, which is contiguous for the chunk.  There is no
//     128-lane padding: that was a Mosaic constraint on a DMA's row, and
//     this copy moves rows of any width.
//   * Each thread issues K loads into registers before their K stores, in
//     place of the TPU kernel's K outstanding DMAs; K is 4, 8, 16 or 32, the
//     values the script sweeps.  A block has min(1024, 8192 / K) threads,
//     so that it keeps about 8192 words in flight at every K: at K = 8,
//     1024 threads took 0.678 ms at (a) and 0.0321 ms at (b') where 256
//     took 0.702 and 0.0357 (in turns, one call; K = 32 at 256 threads was
//     as fast as 1024 at K = 8).
//   * The kernel checks the indices itself, where they already are: each
//     thread compares the indices it loads into shared memory with the
//     table's row count N, and __syncthreads_or tells the whole block.  An
//     index outside [0, N), where the TPU's DMA leaves the row undefined,
//     stops the kernel with a trap before the block reads any table row; the
//     launch returns at once, the error surfaces as a CUDA error at the
//     caller's next synchronizing call, and the context is then unusable, as
//     after torch's own device-side index checks.  So the wrapper checks
//     nothing on the card and never waits for it.  All offsets are 64-bit.
//
// The C entry point returns cudaGetLastError() after its launch (or
// cudaErrorInvalidValue for arguments it does not take), as an int; 0 is
// success.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The block for K loads a thread: about 8192 words in flight a block.
constexpr int threads_for(int K) { return 8192 / K < 1024 ? 8192 / K : 1024; }

template <typename Word, int K, int kThreads = threads_for(K)>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const Word* __restrict__ table, const int* __restrict__ idx,
                  Word* __restrict__ out, long long L, long long N, int words, int chunk) {
  extern __shared__ int chunk_idx[];
  const long long row0 = (long long)blockIdx.x * chunk;
  const int rows = (int)min((long long)chunk, L - row0);
  bool outside = false;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int i = __ldg(idx + row0 + r);
    outside |= i < 0 || i >= N;
    chunk_idx[r] = i;
  }
  // an index outside the table stops the whole grid before this block reads a row
  if (__syncthreads_or(outside)) __trap();

  const int items = rows * words;
  Word* const out_chunk = out + row0 * words;
  for (int base = threadIdx.x; base < items; base += K * kThreads) {
    Word v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = base + k * kThreads;
      if (t < items) {
        const int r = t / words;
        v[k] = __ldg(table + (long long)chunk_idx[r] * words + (t - r * words));
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = base + k * kThreads;
      if (t < items) out_chunk[t] = v[k];
    }
  }
}

template <typename Word, int K>
int launch(const void* table, const int* idx, void* out, long long L, long long N, int words,
           int chunk, void* stream) {
  const long long blocks = (L + chunk - 1) / chunk;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  row_gather_kernel<Word, K><<<(unsigned)blocks, threads_for(K), chunk * sizeof(int),
                               (cudaStream_t)stream>>>(
      static_cast<const Word*>(table), idx, static_cast<Word*>(out), L, N, words, chunk);
  return (int)cudaGetLastError();
}

template <typename Word>
int launch_k(int K, const void* table, const int* idx, void* out, long long L, long long N,
             int words, int chunk, void* stream) {
  switch (K) {
    case 4: return launch<Word, 4>(table, idx, out, L, N, words, chunk, stream);
    case 8: return launch<Word, 8>(table, idx, out, L, N, words, chunk, stream);
    case 16: return launch<Word, 16>(table, idx, out, L, N, words, chunk, stream);
    case 32: return launch<Word, 32>(table, idx, out, L, N, words, chunk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// table [N, row_bytes / V words], idx [L] int32, out [L, row_bytes / V words];
// V = vec_bytes in {1, 2, 4, 8, 16} divides row_bytes and both addresses;
// chunk * 4 bytes of indices fit the default 48 KB of shared memory.
int cgt_row_gather(const void* table, const int* idx, void* out, long long L, long long N,
                   int row_bytes, int vec_bytes, int k_outstanding, int chunk, void* stream) {
  if (L <= 0 || N <= 0 || row_bytes <= 0 || vec_bytes <= 0 || row_bytes % vec_bytes ||
      chunk <= 0 || chunk > 12288 || (long long)chunk * (row_bytes / vec_bytes) > 0x3fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int words = row_bytes / vec_bytes;
  switch (vec_bytes) {
    case 16: return launch_k<uint4>(k_outstanding, table, idx, out, L, N, words, chunk, stream);
    case 8: return launch_k<uint2>(k_outstanding, table, idx, out, L, N, words, chunk, stream);
    case 4:
      return launch_k<unsigned int>(k_outstanding, table, idx, out, L, N, words, chunk, stream);
    case 2:
      return launch_k<unsigned short>(k_outstanding, table, idx, out, L, N, words, chunk, stream);
    case 1:
      return launch_k<unsigned char>(k_outstanding, table, idx, out, L, N, words, chunk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
