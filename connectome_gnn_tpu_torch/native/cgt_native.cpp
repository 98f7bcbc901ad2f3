// Native host-side graph preprocessing kernels.
//
// The TPU compute path is JAX/XLA/Pallas; this library accelerates the
// *host* runtime around it — the giant-graph ingest path (reordering,
// band packing) whose numpy implementations are Python-loop- or
// np.add.at-bound at voxel-connectome scale (millions of nodes/edges).
//
// Every function is an exact drop-in for its numpy reference (same visit
// order, same float accumulation order → bitwise-identical results); the
// equivalence is asserted in tests/test_native.py.  Plain C ABI, driven
// from Python via ctypes on raw numpy buffers — no pybind11 dependency.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Reverse Cuthill-McKee ordering over a symmetrized CSR adjacency.
//
// Mirrors connectome_gnn_tpu/data/reorder.py::reverse_cuthill_mckee
// exactly: components seeded from minimum-degree unvisited nodes (stable
// by index), per-node neighbor lists deduplicated ascending, unvisited
// neighbors enqueued stably by degree, final order reversed.
//
// indptr: [n+1], indices: [indptr[n]] (may contain duplicates),
// degree: [n] (duplicate-counting, as the numpy path computes it),
// out: [n] receives perm with perm[new] = old.
void cgt_rcm(int64_t n, const int64_t* indptr, const int64_t* indices,
             const int64_t* degree, int64_t* out) {
  std::vector<char> visited(n, 0);
  std::vector<int64_t> seeds(n);
  for (int64_t i = 0; i < n; ++i) seeds[i] = i;
  std::stable_sort(seeds.begin(), seeds.end(), [&](int64_t a, int64_t b) {
    return degree[a] < degree[b];
  });

  std::vector<int64_t> queue;
  queue.reserve(n);
  std::vector<int64_t> nbrs;
  int64_t pos = 0;
  for (int64_t s : seeds) {
    if (visited[s]) continue;
    visited[s] = 1;
    size_t qhead = queue.size();
    queue.push_back(s);
    while (qhead < queue.size()) {
      int64_t node = queue[qhead++];
      out[pos++] = node;
      nbrs.assign(indices + indptr[node], indices + indptr[node + 1]);
      std::sort(nbrs.begin(), nbrs.end());
      nbrs.erase(std::unique(nbrs.begin(), nbrs.end()), nbrs.end());
      nbrs.erase(std::remove_if(nbrs.begin(), nbrs.end(),
                                [&](int64_t x) { return visited[x]; }),
                 nbrs.end());
      for (int64_t x : nbrs) visited[x] = 1;
      std::stable_sort(nbrs.begin(), nbrs.end(), [&](int64_t a, int64_t b) {
        return degree[a] < degree[b];
      });
      for (int64_t x : nbrs) queue.push_back(x);
    }
  }
  std::reverse(out, out + n);
}

// COO → block-band packing: band[rb, d+W, r%block, s%block] += w.
//
// Mirrors the np.add.at call in connectome_gnn_tpu/ops/banded.py::to_banded
// (same sequential accumulation order → bitwise-identical floats).
// band must be zero-initialized, shape [nb, 2W+1, block, block] C-order.
void cgt_band_pack(int64_t e, const int64_t* senders,
                   const int64_t* receivers, const float* weights,
                   int64_t block, int64_t W, float* band) {
  const int64_t d1 = (2 * W + 1) * block * block;
  const int64_t d2 = block * block;
  for (int64_t i = 0; i < e; ++i) {
    const int64_t r = receivers[i];
    const int64_t s = senders[i];
    const int64_t rb = r / block;
    const int64_t d = s / block - rb + W;
    band[rb * d1 + d * d2 + (r % block) * block + (s % block)] += weights[i];
  }
}

// Row-block-windowed COO → block-band packing for streamed per-shard
// ingest: band is a slab of nb_rows block rows starting at global block
// row rb_lo; edges whose receiver block falls outside [rb_lo,
// rb_lo+nb_rows) are skipped.  Visiting edges in input order regardless
// of the window keeps the per-cell accumulation order identical to a
// full-band cgt_band_pack, so the slab is bitwise-equal to the matching
// rows of the full band.  band must be zero-initialized, shape
// [nb_rows, 2W+1, block, block] C-order.
void cgt_band_pack_range(int64_t e, const int64_t* senders,
                         const int64_t* receivers, const float* weights,
                         int64_t block, int64_t W, int64_t rb_lo,
                         int64_t nb_rows, float* band) {
  const int64_t d1 = (2 * W + 1) * block * block;
  const int64_t d2 = block * block;
  for (int64_t i = 0; i < e; ++i) {
    const int64_t r = receivers[i];
    const int64_t s = senders[i];
    const int64_t rb = r / block - rb_lo;
    if (rb < 0 || rb >= nb_rows) continue;
    const int64_t d = s / block - r / block + W;
    band[rb * d1 + d * d2 + (r % block) * block + (s % block)] += weights[i];
  }
}

// Dense [n, n] adjacency accumulation: adj[r, s] += w.
// Mirrors np.add.at in the dense collate path.
void cgt_dense_pack(int64_t e, const int64_t* senders,
                    const int64_t* receivers, const float* weights,
                    int64_t n, float* adj) {
  for (int64_t i = 0; i < e; ++i) {
    adj[receivers[i] * n + senders[i]] += weights[i];
  }
}

// k-hop fanout neighbor sampling (GraphSAGE-style), the C++ counterpart
// of connectome_gnn_tpu/data/sampling.py::sample_subgraph.
//
// Same traversal semantics (frontier expansion over in-edges grouped by
// receiver, up to fanout[h] sampled in-edges per node at hop h, nodes
// recorded in discovery order with seeds first, kept edge ids returned
// sorted-unique); sampling uses a splitmix64 PRNG via partial
// Fisher-Yates, so draws are uniform-without-replacement but NOT the
// numpy Generator stream — use the numpy path when bitwise numpy parity
// matters, this one for throughput.
//
// order/starts/ends: receiver-grouped edge index (order[starts[v]..ends[v])
// are edge ids with receiver v); src: edge senders [E].
// out_nodes (cap num_nodes) and out_edges (cap E) receive the results;
// returns 0 on success.
static inline uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

extern "C" int64_t cgt_sample_subgraph(
    int64_t num_nodes, int64_t num_edges, const int64_t* order,
    const int64_t* starts, const int64_t* ends, const int64_t* src,
    int64_t num_seeds, const int64_t* seeds, int64_t num_hops,
    const int64_t* fanout, uint64_t rng_seed, int64_t* out_nodes,
    int64_t* out_n_nodes, int64_t* out_edges, int64_t* out_n_edges) {
  std::vector<int64_t> visited(num_nodes, -1);
  std::vector<int64_t> kept;  // per-node expansions are distinct edges and
  std::vector<int64_t> frontier, next_frontier, scratch;  // each node is
  int64_t n_nodes = 0;  // expanded once → no dedup needed, just a sort

  for (int64_t i = 0; i < num_seeds; ++i) {
    int64_t s = seeds[i];
    if (s < 0 || s >= num_nodes) return 1;
    if (visited[s] < 0) {
      visited[s] = n_nodes;
      out_nodes[n_nodes++] = s;
      frontier.push_back(s);
    }
  }

  uint64_t rng = rng_seed ^ 0xD1B54A32D192ED03ull;
  for (int64_t hop = 0; hop < num_hops && !frontier.empty(); ++hop) {
    const int64_t f = fanout[hop];
    next_frontier.clear();
    for (int64_t node : frontier) {
      const int64_t lo = starts[node], hi = ends[node];
      const int64_t deg = hi - lo;
      scratch.assign(order + lo, order + hi);
      int64_t take = deg < f ? deg : f;
      for (int64_t k = 0; k < take; ++k) {
        // partial Fisher-Yates: uniform without replacement
        int64_t j = k + (int64_t)(splitmix64(&rng) % (uint64_t)(deg - k));
        std::swap(scratch[k], scratch[j]);
        const int64_t e = scratch[k];
        kept.push_back(e);
        const int64_t nbr = src[e];
        // corrupt edge lists must fail loudly like the numpy path, not
        // write out of bounds
        if (nbr < 0 || nbr >= num_nodes) return 2;
        if (visited[nbr] < 0) {
          visited[nbr] = n_nodes;
          out_nodes[n_nodes++] = nbr;
          next_frontier.push_back(nbr);
        }
      }
    }
    frontier.swap(next_frontier);
  }

  // O(K log K) in kept edges, independent of total edge count — the
  // per-sample cost must scale with the minibatch, not the graph
  std::sort(kept.begin(), kept.end());
  for (size_t i = 0; i < kept.size(); ++i) out_edges[i] = kept[i];
  *out_n_nodes = n_nodes;
  *out_n_edges = (int64_t)kept.size();
  return 0;
}

// ---- Fused sampling + collate ---------------------------------------
//
// Per-step minibatch production for giant-graph sampled training is
// host-bound (measured at 1M nodes: ~9 ms in cgt_sample_subgraph — mostly
// the O(num_nodes) visited init — plus ~13 ms of Python-side relabeling
// through a fresh num_nodes-sized map, per step).  This kernel keeps the
// visited scratch alive across calls in a handle (reset cost = touched
// nodes only) and emits the padded, locally-relabeled, receiver-sorted
// arrays the static-shape batch wants in ONE traversal — per-call cost
// scales with the sample, not the graph.
//
// Emission order: nodes get local ids in discovery order (seeds first);
// each hop expands the frontier in increasing local-id order, so edges
// come out grouped by receiver with receiver ids ascending — exactly the
// receiver-sorted layout segment_sum's indices_are_sorted wants.  (Within
// one receiver, edges are in draw order rather than global-edge-id order;
// the per-receiver edge SET matches cgt_sample_subgraph bit-for-bit for
// the same rng_seed, since the traversal and splitmix64 stream are
// identical.)
//
// Return codes: 0 ok, 1 seed out of range, 2 corrupt sender id,
// 3 node budget exceeded, 4 edge budget exceeded, 5 duplicate seed.

struct CgtSampler {
  std::vector<int32_t> visited;  // -1 or local id; reset after every call
  std::vector<int32_t> frontier, next_frontier;
  std::vector<int64_t> scratch;
  explicit CgtSampler(int64_t n) : visited(static_cast<size_t>(n), -1) {}
};

void* cgt_sampler_new(int64_t num_nodes) {
  return new CgtSampler(num_nodes);
}

void cgt_sampler_free(void* handle) {
  delete static_cast<CgtSampler*>(handle);
}

int64_t cgt_sampler_sample_collate(
    void* handle, const int64_t* order, const int64_t* starts,
    const int64_t* ends, const int64_t* src, const float* edge_weight,
    int64_t num_seeds, const int64_t* seeds, int64_t num_hops,
    const int64_t* fanout, uint64_t rng_seed, int64_t node_budget,
    int64_t edge_budget, int32_t* out_senders, int32_t* out_receivers,
    float* out_weights, int32_t* out_node_ids, int64_t* out_n_nodes,
    int64_t* out_n_edges) {
  CgtSampler& S = *static_cast<CgtSampler*>(handle);
  const int64_t num_nodes = static_cast<int64_t>(S.visited.size());
  int64_t n_nodes = 0, n_edges = 0, rc = 0;

  S.frontier.clear();
  for (int64_t i = 0; i < num_seeds; ++i) {
    const int64_t s = seeds[i];
    if (s < 0 || s >= num_nodes) { rc = 1; goto done; }
    if (S.visited[s] >= 0) { rc = 5; goto done; }
    if (n_nodes >= node_budget) { rc = 3; goto done; }
    S.visited[s] = static_cast<int32_t>(n_nodes);
    out_node_ids[n_nodes++] = static_cast<int32_t>(s);
    S.frontier.push_back(static_cast<int32_t>(s));
  }

  {
    uint64_t rng = rng_seed ^ 0xD1B54A32D192ED03ull;
    for (int64_t hop = 0; hop < num_hops && !S.frontier.empty(); ++hop) {
      const int64_t f = fanout[hop];
      S.next_frontier.clear();
      for (int32_t node : S.frontier) {
        const int64_t lo = starts[node], hi = ends[node];
        const int64_t deg = hi - lo;
        const int32_t r_local = S.visited[node];
        S.scratch.assign(order + lo, order + hi);
        const int64_t take = deg < f ? deg : f;
        for (int64_t k = 0; k < take; ++k) {
          const int64_t j =
              k + static_cast<int64_t>(splitmix64(&rng) %
                                       static_cast<uint64_t>(deg - k));
          std::swap(S.scratch[k], S.scratch[j]);
          const int64_t e = S.scratch[k];
          const int64_t nbr = src[e];
          if (nbr < 0 || nbr >= num_nodes) { rc = 2; goto done; }
          if (S.visited[nbr] < 0) {
            if (n_nodes >= node_budget) { rc = 3; goto done; }
            S.visited[nbr] = static_cast<int32_t>(n_nodes);
            out_node_ids[n_nodes++] = static_cast<int32_t>(nbr);
            S.next_frontier.push_back(static_cast<int32_t>(nbr));
          }
          if (n_edges >= edge_budget) { rc = 4; goto done; }
          out_senders[n_edges] = S.visited[nbr];
          out_receivers[n_edges] = r_local;
          out_weights[n_edges] = edge_weight[e];
          ++n_edges;
        }
      }
      S.frontier.swap(S.next_frontier);
    }

    // padding: edges target the last node slot with weight 0 (inert and
    // receiver-sorted since node_budget-1 >= any real local id)
    for (int64_t i = n_edges; i < edge_budget; ++i) {
      out_senders[i] = static_cast<int32_t>(node_budget - 1);
      out_receivers[i] = static_cast<int32_t>(node_budget - 1);
      out_weights[i] = 0.0f;
    }
    for (int64_t i = n_nodes; i < node_budget; ++i) out_node_ids[i] = -1;
  }

done:
  // touched-only reset — the handle's reuse contract
  for (int64_t i = 0; i < n_nodes; ++i) S.visited[out_node_ids[i]] = -1;
  *out_n_nodes = n_nodes;
  *out_n_edges = n_edges;
  return rc;
}

}  // extern "C"
