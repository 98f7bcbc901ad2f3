"""Graph reordering for bandwidth reduction (host side, numpy and scipy).

The port of ``connectome_gnn_tpu/data/reorder.py``.  The banded SpMM
(:mod:`connectome_gnn_tpu_torch.ops.banded`) needs node orderings where
edges connect nearby indices.  Reverse-Cuthill-McKee (BFS from a low-degree
node, neighbours visited degree-ascending, order reversed) recovers them at
O(N + E) cost, through the native helper where it is built
(:mod:`connectome_gnn_tpu_torch.native`) and its numpy BFS otherwise,
bitwise the same.  :func:`spectral_ordering`, the shortcut-robust ordering
that RCM is not, is the iteratively reweighted Fiedler ordering.  Both are
the JAX package's code, so their permutations equal its, bit for bit.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from connectome_gnn_tpu_torch.data.graph import ConnectomeGraph


def reverse_cuthill_mckee(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """RCM permutation: ``perm[new_index] = old_index``.

    Handles disconnected graphs (each component seeded from its
    minimum-degree unvisited node) and isolated nodes.
    """
    # BFS over the symmetrized adjacency (edge direction is irrelevant to
    # bandwidth; the input may store only one direction)
    src = np.concatenate([edge_index[0], edge_index[1]]).astype(np.int64)
    dst = np.concatenate([edge_index[1], edge_index[0]]).astype(np.int64)
    order = np.argsort(dst, kind="stable")
    src_sorted = src[order]
    starts = np.searchsorted(dst[order], np.arange(num_nodes))
    ends = np.searchsorted(dst[order], np.arange(num_nodes), side="right")
    degree = ends - starts

    from connectome_gnn_tpu_torch import native

    if native.AVAILABLE:
        # dst is sorted, so ends[i] == starts[i + 1]: the CSR indptr directly
        indptr = np.concatenate([starts, [src_sorted.shape[0]]]).astype(np.int64)
        return native.rcm(indptr, src_sorted, degree.astype(np.int64))
    return _rcm_numpy(num_nodes, src_sorted, starts, ends, degree)


def _rcm_numpy(
    num_nodes: int,
    src_sorted: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    degree: np.ndarray,
) -> np.ndarray:
    """The RCM BFS over a CSR (``src_sorted`` rows ``starts:ends``): the
    path without the native helper, and its oracle."""
    visited = np.zeros(num_nodes, bool)
    result: list[int] = []
    by_degree = np.argsort(degree, kind="stable")

    for seed in by_degree:
        if visited[seed]:
            continue
        visited[seed] = True
        queue = deque([int(seed)])
        while queue:
            node = queue.popleft()
            result.append(node)
            nbrs = np.unique(src_sorted[starts[node] : ends[node]])
            nbrs = nbrs[~visited[nbrs]]
            visited[nbrs] = True
            for nbr in nbrs[np.argsort(degree[nbrs], kind="stable")]:
                queue.append(int(nbr))

    return np.asarray(result[::-1], np.int64)


def _lobpcg_fiedler(adj, x0, *, tol: float, maxiter: int) -> np.ndarray:
    """Fiedler vector of ``adj``'s Laplacian via LOBPCG (Jacobi
    preconditioner, constant vector constrained out), unit variance."""
    import warnings

    import scipy.sparse as sp
    from scipy.sparse.linalg import lobpcg

    n = adj.shape[0]
    deg = np.asarray(adj.sum(axis=1)).ravel()
    lap = sp.diags(deg) - adj
    ones = np.ones((n, 1)) / np.sqrt(n)
    m_inv = sp.diags(1.0 / np.maximum(deg, 1e-12))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, vec = lobpcg(
            lap, x0, M=m_inv, Y=ones, tol=tol, maxiter=maxiter,
            largest=False,
        )
    v = vec[:, 0]
    return v / max(float(v.std()), 1e-30)


def spectral_ordering(
    edge_index: np.ndarray,
    num_nodes: int,
    edge_weight: np.ndarray | None = None,
    *,
    tol: float = 1e-8,
    maxiter: int = 200,
    reweight_iters: int = 3,
    seed: int = 0,
    return_iterates: bool = False,
    solver: str = "relax",
    relax_iters: int | None = None,
) -> np.ndarray | list[np.ndarray]:
    """Iteratively reweighted Fiedler ordering: ``perm[new] = old``.

    Sorts nodes by the second-smallest eigenvector of the graph Laplacian
    (the 1-D embedding minimizing ``Σ w_ij (p_i - p_j)²``, Barnard, Pothen
    and Simon's spectral envelope reduction), then reweights: edges
    stretched in the current embedding are downweighted
    (``w ← w₀ / (1 + stretch/9σ)``) and the embedding solved again,
    ``reweight_iters`` times, warm-started.  RCM's BFS levels are
    teleported by any shortcut, and uniform shortcuts make the plain
    Fiedler vector an expander's, with no geometry; the stretched edges are
    exactly the shortcuts, so the reweighting recovers the latent band.
    Too many rounds can disconnect the downweighted graph, so a caller
    that can price orderings (``plan_layout``) passes
    ``return_iterates=True`` and takes the cheapest.

    ``solver="relax"`` (the default) runs ``relax_iters`` lazy-random-walk
    sweeps (``x ← ½x + ½D⁻¹Wx``, each component's mean deflated: the
    algebraic-distance smoother) on a CSR built once, whose weights each
    round updates through a precomputed slot map.  It is deliberately not
    an eigensolver: the under-converged low-frequency mix is the signal
    the reweighting amplifies.  ``"lobpcg"`` solves each connected
    component with LOBPCG (``tol``, ``maxiter``), the oracle of the relax
    path.  The JAX package's docstring keeps the measurements behind both
    choices (``connectome_gnn_tpu/data/reorder.py:102-185``).
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    src = np.concatenate([edge_index[0], edge_index[1]]).astype(np.int64)
    dst = np.concatenate([edge_index[1], edge_index[0]]).astype(np.int64)
    if edge_weight is None:
        w0 = np.ones(src.shape[0], np.float64)
    else:
        w0 = np.abs(
            np.concatenate([edge_weight, edge_weight]).astype(np.float64)
        )

    # symmetric CSR built once (duplicates kept: matvec sums them); each
    # IRLS round changes only `.data`, through the `order` slot map
    nnz = src.shape[0]
    # stable single-key sort by receiver only: CSR matvec does not need
    # within-row sorted columns, and argsort is much cheaper than
    # lexsort at 10⁸ entries
    order = np.argsort(dst, kind="stable")
    idx_dtype = np.int32 if nnz < np.iinfo(np.int32).max else np.int64
    indices = src[order].astype(idx_dtype)
    indptr = np.zeros(num_nodes + 1, idx_dtype)
    np.cumsum(np.bincount(dst, minlength=num_nodes), out=indptr[1:])

    def matrix(w) -> sp.csr_matrix:
        a = sp.csr_matrix(
            (np.ascontiguousarray(w[order]), indices, indptr),
            shape=(num_nodes, num_nodes),
        )
        return a

    if relax_iters is None:
        # generous where sweeps are cheap, lean at giant scale, where each
        # streams the whole edge list (the JAX package's budget)
        relax_iters = 30 if num_nodes > 100_000 else 120

    struct = matrix(np.ones_like(w0))
    n_comp, comp = connected_components(struct, directed=False)
    comp_counts = np.bincount(comp, minlength=n_comp).astype(np.float64)
    rng = np.random.default_rng(seed)

    def solve_relax(w, warm: np.ndarray | None) -> np.ndarray:
        """Fixed-budget JOR relaxation (ω = ½, the lazy random walk),
        deflated per component."""
        a = matrix(w)
        d = np.asarray(a.sum(axis=1)).ravel()
        dinv = 1.0 / np.maximum(d, 1e-30)
        x = (
            warm.astype(np.float64, copy=True)
            if warm is not None
            else rng.standard_normal(num_nodes)
        )
        for _ in range(relax_iters):
            x = 0.5 * x + 0.5 * ((a @ x) * dinv)
            x -= (
                np.bincount(comp, weights=x, minlength=n_comp)
                / comp_counts
            )[comp]
            norm = float(np.linalg.norm(x))
            if norm > 0.0:
                x /= norm
        var = (
            np.bincount(comp, weights=x * x, minlength=n_comp)
            / comp_counts
        )
        return x / np.maximum(np.sqrt(var), 1e-30)[comp]

    def solve_lobpcg(w, warm: np.ndarray | None) -> np.ndarray:
        adj = matrix(w)
        key = np.zeros(num_nodes, np.float64)
        for c in range(n_comp):
            nodes = np.flatnonzero(comp == c)
            if nodes.size <= 2:
                key[nodes] = np.arange(nodes.size)
                continue
            sub = adj[nodes][:, nodes].tocsr()
            x0 = (
                warm[nodes][:, None]
                if warm is not None
                else rng.standard_normal((nodes.size, 1))
            )
            try:
                key[nodes] = _lobpcg_fiedler(
                    sub, x0, tol=tol, maxiter=maxiter
                )
            except Exception:
                # eigensolver breakdown (degenerate component): keep
                # input order
                key[nodes] = np.arange(nodes.size)
        return key

    def to_perm(key) -> np.ndarray:
        # stable sort by (component, fiedler value): components contiguous
        return np.lexsort((key, comp)).astype(np.int64)

    solve = solve_relax if solver == "relax" else solve_lobpcg
    v = solve(w0, None)
    iterates = [to_perm(v)]
    for _ in range(reweight_iters):
        stretch = (v[src] - v[dst]) ** 2
        pos = stretch[stretch > 0]
        sigma = float(np.median(pos)) if pos.size else 1.0
        w = w0 / (1.0 + stretch / (9.0 * sigma + 1e-30))
        v = solve(w, v)
        iterates.append(to_perm(v))
    return iterates if return_iterates else iterates[-1]


def apply_ordering(graph: ConnectomeGraph, perm: np.ndarray) -> ConnectomeGraph:
    """Relabel a graph by ``perm`` (``perm[new] = old``)."""
    inverse = np.empty_like(perm)
    inverse[perm] = np.arange(len(perm))
    return ConnectomeGraph(
        node_features=graph.node_features[perm],
        edge_index=inverse[graph.edge_index.astype(np.int64)].astype(np.int32),
        edge_weight=graph.edge_weight,
        label=graph.label,
        subject_id=graph.subject_id,
    )


def bandwidth(edge_index: np.ndarray) -> int:
    """Maximum |sender - receiver| index distance over all edges."""
    if edge_index.shape[1] == 0:
        return 0
    return int(np.abs(edge_index[0].astype(np.int64) - edge_index[1].astype(np.int64)).max())
