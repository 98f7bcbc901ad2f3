// Random-row gather B1 for NVIDIA Hopper (built for sm_90a):
// out[i, :] = table[idx[i], :] for a table [N, F] of any element type and
// int32 indices [L], a byte copy of each row.
//
// Replaces the Pallas TPU kernel dma_gather of
// benchmarks/gather_dma_experiments.py:52-111 (pallas_call at :91), which
// walks chunks of C indices held in SMEM and keeps K single-row HBM->VMEM
// DMAs in flight over a sliding window of K semaphores.  K and C change no
// value; neither does anything here: every output row is one row's bytes.
//
// What bounds it on this card.  It is pure data movement: the rows the
// indices touch are read, the output is written, the indices are read, once
// each, so its least time is those bytes over 3.35 TB/s.  At the script's
// shapes (gather_dma_experiments.py:245-252) that is about 0.35 ms for 4M
// rows of 256 B (the output alone is 1.07 GB), 18 us for 131,072 rows of
// 256 B and under a microsecond for 131,072 rows of 8 B, below any launch.
// A random row is a scattered read: a 256-B row is eight 32-B sectors read
// whole, an 8-B row one sector of which a quarter is used.
//
// What the design does about it (a simple kernel; making it fast is later
// work).
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
//   * Each thread issues K loads into registers before their K stores, so a
//     warp has K load instructions in flight (K rows or more), in place of
//     the TPU kernel's K outstanding DMAs.  K is 4, 8, 16 or 32, the values
//     the script sweeps.
//   * The kernel does not check the indices: the wrapper does (one device
//     reduction) and raises for any index outside [0, N), where the TPU's
//     DMA leaves the result undefined.  All offsets are 64-bit.
//
// The C entry point returns cudaGetLastError() after its launch (or
// cudaErrorInvalidValue for arguments it does not take), as an int; 0 is
// success.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename Word, int K>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const Word* __restrict__ table, const int* __restrict__ idx,
                  Word* __restrict__ out, long long L, int words, int chunk) {
  extern __shared__ int chunk_idx[];
  const long long row0 = (long long)blockIdx.x * chunk;
  const int rows = (int)min((long long)chunk, L - row0);
  for (int r = threadIdx.x; r < rows; r += kThreads) chunk_idx[r] = __ldg(idx + row0 + r);
  __syncthreads();

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
int launch(const void* table, const int* idx, void* out, long long L, int words, int chunk,
           void* stream) {
  const long long blocks = (L + chunk - 1) / chunk;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  row_gather_kernel<Word, K><<<(unsigned)blocks, kThreads, chunk * sizeof(int),
                               (cudaStream_t)stream>>>(
      static_cast<const Word*>(table), idx, static_cast<Word*>(out), L, words, chunk);
  return (int)cudaGetLastError();
}

template <typename Word>
int launch_k(int K, const void* table, const int* idx, void* out, long long L, int words,
             int chunk, void* stream) {
  switch (K) {
    case 4: return launch<Word, 4>(table, idx, out, L, words, chunk, stream);
    case 8: return launch<Word, 8>(table, idx, out, L, words, chunk, stream);
    case 16: return launch<Word, 16>(table, idx, out, L, words, chunk, stream);
    case 32: return launch<Word, 32>(table, idx, out, L, words, chunk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// table [N, row_bytes / V words], idx [L] int32, out [L, row_bytes / V words];
// V = vec_bytes in {1, 2, 4, 8, 16} divides row_bytes and both addresses;
// chunk * 4 bytes of indices fit the default 48 KB of shared memory.
int cgt_row_gather(const void* table, const int* idx, void* out, long long L, int row_bytes,
                   int vec_bytes, int k_outstanding, int chunk, void* stream) {
  if (L <= 0 || row_bytes <= 0 || vec_bytes <= 0 || row_bytes % vec_bytes || chunk <= 0 ||
      chunk > 12288 || (long long)chunk * (row_bytes / vec_bytes) > 0x3fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int words = row_bytes / vec_bytes;
  switch (vec_bytes) {
    case 16: return launch_k<uint4>(k_outstanding, table, idx, out, L, words, chunk, stream);
    case 8: return launch_k<uint2>(k_outstanding, table, idx, out, L, words, chunk, stream);
    case 4: return launch_k<unsigned int>(k_outstanding, table, idx, out, L, words, chunk, stream);
    case 2:
      return launch_k<unsigned short>(k_outstanding, table, idx, out, L, words, chunk, stream);
    case 1:
      return launch_k<unsigned char>(k_outstanding, table, idx, out, L, words, chunk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
