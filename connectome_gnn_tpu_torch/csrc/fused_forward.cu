// Whole-model eval forwards of GCNConnectome (K1) and GraphSAGEConnectome
// (K2) in one launch each, for NVIDIA Hopper (built for sm_90a).
//
// Replaces the Pallas TPU kernels in connectome_gnn_tpu/ops/fused_pallas.py:
//   K1  fused_gcn_forward  / _fused_gcn_kernel   (pallas_call at :218)
//   K2  fused_sage_forward / _fused_sage_kernel  (pallas_call at :487)
//
// What bounds it on this card.  A flagship batch (n = 88 padded nodes,
// H = 64, L = 3) costs about 2.6 M multiply-adds per graph against 31 KB of
// adjacency and 1.8 KB of features read from device memory: some 80 FMAs per
// byte, so the product loops are bound by shared-memory bandwidth and issue,
// not by HBM.  The serving batches are small (16 graphs on 132 SMs), so at
// batch 16 the launch and the per-graph latency dominate.
//
// What the design does about it.
//   * One thread block per graph.  The TPU grid walked groups of graphs in
//     order and ran the MLP head in its last step over a scratch that
//     persisted across steps; here every block finishes its own graph's
//     logits, head included, and no state passes between blocks.  The
//     group-size heuristic and the scoped-VMEM retry have no counterpart.
//   * The graph's adjacency, activations and per-layer products live in
//     shared memory in f32 for the whole forward; only the inputs are read
//     from and the logits written to device memory.  The weights are read
//     from global memory through L1/L2.  Above 48 KB the kernel takes
//     dynamic shared memory, opted into with cudaFuncSetAttribute; the
//     Python wrapper computes the same byte count and refuses shapes that
//     exceed the 227 KB a block may hold.
//   * Plain f32 FMA loops (no tensor cores, no TF32).  Each thread computes
//     kRowTile rows of one output column, so one operand load of the shared
//     B row serves kRowTile FMAs and the A loads are warp broadcasts.
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
// Each C entry point returns cudaGetLastError() after its launch (or the
// error of the attribute call before it), as an int; 0 is success.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 4;         // rows per thread in block_product
constexpr int kSageChunkRows = 16;  // rows of z staged per step in K2
constexpr float kEps = 1e-8f;

// out(i, o) = sum_k A1[i, k] B1[k, o] + sum_k A2[i, k] B2[k, o]
// for i < M, o < N, handed to epi(i, o, value).  Row-major operands with
// leading dimensions lda/ldb; K2 = 0 drops the second product.
template <typename Epilogue>
__device__ __forceinline__ void block_product(
    const float* A1, int lda1, const float* B1, int ldb1, int K1,
    const float* A2, int lda2, const float* B2, int ldb2, int K2,
    int M, int N, Epilogue epi) {
  const int groups = (M + kRowTile - 1) / kRowTile;
  for (int item = threadIdx.x; item < groups * N; item += blockDim.x) {
    const int o = item % N;
    const int i0 = (item / N) * kRowTile;
    int rows[kRowTile];
    float acc[kRowTile];
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
      rows[r] = min(i0 + r, M - 1);  // ragged edge: recompute the last row
      acc[r] = 0.f;
    }
    for (int k = 0; k < K1; ++k) {
      const float b = B1[k * ldb1 + o];
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) acc[r] = fmaf(A1[rows[r] * lda1 + k], b, acc[r]);
    }
    for (int k = 0; k < K2; ++k) {
      const float b = B2[k * ldb2 + o];
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) acc[r] = fmaf(A2[rows[r] * lda2 + k], b, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRowTile; ++r)
      if (i0 + r < M) epi(i0 + r, o, acc[r]);
  }
}

// Masked mean-pool of h [n, H] (row stride D) and the 2-layer MLP head.
__device__ __forceinline__ void pool_and_head(
    const float* s_h, int D, const float* s_mask, float* s_pool, float* s_hid,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ out_g, int n, int H, int H2, int C) {
  for (int o = threadIdx.x; o < H; o += blockDim.x) {
    float s = 0.f, cnt = 0.f;
    for (int i = 0; i < n; ++i) {
      s += s_h[i * D + o] * s_mask[i];
      cnt += s_mask[i];
    }
    s_pool[o] = s / (cnt + kEps);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < H2; j += blockDim.x) {
    float v = 0.f;
    for (int k = 0; k < H; ++k) v = fmaf(s_pool[k], w1[k * H2 + j], v);
    s_hid[j] = fmaxf(v + b1[j], 0.f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float v = 0.f;
    for (int j = 0; j < H2; ++j) v = fmaf(s_hid[j], w2[j * C + c], v);
    out_g[c] = v + b2[c];
  }
}

// Copy one graph's adjacency, features (row stride D) and mask to shared.
__device__ __forceinline__ void load_graph(
    const float* __restrict__ adj_g, const float* __restrict__ x_g,
    const uint8_t* __restrict__ mask_g, float* s_adj, float* s_h,
    float* s_mask, int n, int F, int D) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) s_adj[idx] = adj_g[idx];
  for (int idx = threadIdx.x; idx < n * F; idx += blockDim.x)
    s_h[(idx / F) * D + idx % F] = x_g[idx];
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_mask[i] = mask_g[i] ? 1.f : 0.f;
}

size_t gcn_smem_floats(int n, int F, int H, int H2) {
  const size_t D = F > H ? F : H;
  return (size_t)n * n + (size_t)n * D + (size_t)n * H + 2 * (size_t)n + H + H2;
}

size_t sage_smem_floats(int n, int F, int H, int H2) {
  const size_t D = F > H ? F : H;
  return (size_t)n * n + 2 * (size_t)n * D + (size_t)kSageChunkRows * H + 2 * (size_t)n + H + H2;
}

__global__ void __launch_bounds__(kThreads) fused_gcn_kernel(
    const float* __restrict__ x, const float* __restrict__ adj,
    const uint8_t* __restrict__ mask, const float* __restrict__ w_in,
    const float* __restrict__ w_h, const float* __restrict__ scale,
    const float* __restrict__ shift, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, float* __restrict__ out, int n, int F,
    int H, int H2, int C, int L) {
  extern __shared__ float smem[];
  const int D = max(F, H);
  float* s_adj = smem;            // [n, n] normalized adjacency
  float* s_h = s_adj + n * n;     // [n, D] activations
  float* s_hw = s_h + n * D;      // [n, H] h·W of the current layer
  float* s_dinv = s_hw + n * H;   // [n]
  float* s_mask = s_dinv + n;     // [n]
  float* s_pool = s_mask + n;     // [H]
  float* s_hid = s_pool + H;      // [H2]

  const size_t g = blockIdx.x;
  load_graph(adj + g * n * n, x + g * n * F, mask + g * n, s_adj, s_h, s_mask, n, F, D);
  __syncthreads();

  // degree of sender j: column sum over receivers i, plus the self-loop
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float deg = 0.f;
    for (int i = 0; i < n; ++i) deg += s_adj[i * n + j];
    s_dinv[j] = rsqrtf(deg + 1.f + kEps);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x)
    s_adj[idx] = s_dinv[idx / n] * s_adj[idx] * s_dinv[idx % n];
  __syncthreads();

  for (int layer = 0; layer < L; ++layer) {
    const int Din = layer == 0 ? F : H;
    const float* W = layer == 0 ? w_in : w_h + (size_t)(layer - 1) * H * H;
    block_product(s_h, D, W, H, Din, nullptr, 0, nullptr, 0, 0, n, H,
                  [&](int i, int o, float v) { s_hw[i * H + o] = v; });
    __syncthreads();
    const float* s_l = scale + layer * H;
    const float* t_l = shift + layer * H;
    block_product(s_adj, n, s_hw, H, n, nullptr, 0, nullptr, 0, 0, n, H,
                  [&](int i, int o, float v) {
                    const float agg = v + s_dinv[i] * s_dinv[i] * s_hw[i * H + o];
                    s_h[i * D + o] = fmaxf(agg * s_l[o] + t_l[o], 0.f);
                  });
    __syncthreads();
  }
  pool_and_head(s_h, D, s_mask, s_pool, s_hid, w1, b1, w2, b2, out + g * C, n, H, H2, C);
}

__global__ void __launch_bounds__(kThreads) fused_sage_kernel(
    const float* __restrict__ x, const float* __restrict__ adj,
    const uint8_t* __restrict__ mask, const float* __restrict__ w_self_in,
    const float* __restrict__ w_agg_in, const float* __restrict__ w_self_h,
    const float* __restrict__ w_agg_h, const float* __restrict__ bias,
    const float* __restrict__ scale, const float* __restrict__ shift,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ out, int n, int F, int H, int H2, int C, int L) {
  extern __shared__ float smem[];
  const int D = max(F, H);
  float* s_adj = smem;                       // [n, n] raw adjacency
  float* s_h = s_adj + n * n;                // [n, D] activations
  float* s_agg = s_h + n * D;                // [n, D] weighted-mean aggregate
  float* s_z = s_agg + n * D;                // [kSageChunkRows, H] staged rows
  float* s_wsum = s_z + kSageChunkRows * H;  // [n]
  float* s_mask = s_wsum + n;                // [n]
  float* s_pool = s_mask + n;                // [H]
  float* s_hid = s_pool + H;                 // [H2]

  const size_t g = blockIdx.x;
  load_graph(adj + g * n * n, x + g * n * F, mask + g * n, s_adj, s_h, s_mask, n, F, D);
  __syncthreads();

  // weight sum of receiver i: ROW sum over senders j
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float w = 0.f;
    for (int j = 0; j < n; ++j) w += s_adj[i * n + j];
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
    block_product(s_adj, n, s_h, D, n, nullptr, 0, nullptr, 0, 0, n, Din,
                  [&](int i, int o, float v) { s_agg[i * D + o] = v / s_wsum[i]; });
    __syncthreads();
    // z row i reads only row i of h and agg, so rows are staged in chunks
    // and written back over h without a second [n, H] buffer
    for (int r0 = 0; r0 < n; r0 += kSageChunkRows) {
      const int rows = min(kSageChunkRows, n - r0);
      block_product(s_h + r0 * D, D, Ws, H, Din, s_agg + r0 * D, D, Wa, H, Din, rows, H,
                    [&](int i, int o, float v) {
                      s_z[i * H + o] = fmaxf(v + b_l[o], 0.f) * s_l[o] + t_l[o];
                    });
      __syncthreads();
      for (int idx = threadIdx.x; idx < rows * H; idx += blockDim.x)
        s_h[(r0 + idx / H) * D + idx % H] = s_z[idx];
      __syncthreads();
    }
  }
  pool_and_head(s_h, D, s_mask, s_pool, s_hid, w1, b1, w2, b2, out + g * C, n, H, H2, C);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem_bytes, size_t needed_floats) {
  if (smem_bytes < needed_floats * sizeof(float)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes);
}

}  // namespace

extern "C" {

int cgt_fused_gcn_forward(
    const float* x, const float* adj, const uint8_t* mask, const float* w_in,
    const float* w_h, const float* scale, const float* shift, const float* w1,
    const float* b1, const float* w2, const float* b2, float* out, int B, int n,
    int F, int H, int H2, int C, int L, size_t smem_bytes, void* stream) {
  cudaError_t err = prepare(fused_gcn_kernel, smem_bytes, gcn_smem_floats(n, F, H, H2));
  if (err != cudaSuccess) return (int)err;
  fused_gcn_kernel<<<B, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      x, adj, mask, w_in, w_h, scale, shift, w1, b1, w2, b2, out, n, F, H, H2, C, L);
  return (int)cudaGetLastError();
}

int cgt_fused_sage_forward(
    const float* x, const float* adj, const uint8_t* mask, const float* w_self_in,
    const float* w_agg_in, const float* w_self_h, const float* w_agg_h,
    const float* bias, const float* scale, const float* shift, const float* w1,
    const float* b1, const float* w2, const float* b2, float* out, int B, int n,
    int F, int H, int H2, int C, int L, size_t smem_bytes, void* stream) {
  cudaError_t err = prepare(fused_sage_kernel, smem_bytes, sage_smem_floats(n, F, H, H2));
  if (err != cudaSuccess) return (int)err;
  fused_sage_kernel<<<B, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      x, adj, mask, w_self_in, w_agg_in, w_self_h, w_agg_h, bias, scale, shift,
      w1, b1, w2, b2, out, n, F, H, H2, C, L);
  return (int)cudaGetLastError();
}

const char* cgt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
