"""Automatic layout recovery for giant sparse graphs (host side).

The port of ``connectome_gnn_tpu/data/layout.py``.  A giant graph's SpMM
runs either as a block band (:mod:`connectome_gnn_tpu_torch.ops.banded`,
a stream of dense tiles), as a band plus a COO remainder (the hybrid
form), or as a COO scatter, whose cost is per edge.  This module recovers
locality where it exists and picks the cheapest form by a cost model:

    plan = plan_layout(senders, receivers, num_nodes)   # analyse, decide
    adj = build_layout(plan, senders, receivers, weights, num_nodes)

:func:`plan_layout` prices, for the input ordering, Reverse-Cuthill-McKee
(:func:`~connectome_gnn_tpu_torch.data.reorder.reverse_cuthill_mckee`) and,
where those leave more than 5 % of the edges out of band, every iterate of
the reweighted spectral ordering
(:func:`~connectome_gnn_tpu_torch.data.reorder.spectral_ordering`), the
modelled time of one SpMM at every band width W: the band's bytes, the
activation windows and the output at ``hbm_gbps``, plus the out-of-band
edges at ``scatter_ns_per_edge``, under a cap on the band's bytes.  It
returns the argmin as a :class:`LayoutPlan`.  The function, its keyword
arguments and its arithmetic are the JAX package's; only the two rates'
defaults differ.

The defaults are this port's rates on an NVIDIA H100 80GB HBM3 at a 700 W
power limit (``nvidia-smi``: ``NVIDIA H100 80GB HBM3, 700.00 W``), measured
by ``chip_smoke.py``'s phase 28 (CUDA events, medians of 20):

* :data:`SCATTER_NS_PER_EDGE`, 1.3375 ns: the port's ``coo_spmm`` (an
  ``index_select`` gather and an ``index_add_``) over 4,194,304 random
  edges among 1,048,576 nodes at F = 64 took 5.6100 ms;
* :data:`HBM_GBPS`, 1234.92 GB/s: the port's float32 ``banded_spmm`` over
  the 1,048,576-node band of ``chip_smoke.py``'s phase 6 (W = 2, block
  256, F = 64) took 5.8690 ms for the 7,247,757,312 bytes that
  :func:`_band_cost_curve` prices for it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from connectome_gnn_tpu_torch.data.batch import card_by_default, round_up

#: ns an edge of the port's COO SpMM on the card (the module docstring)
SCATTER_NS_PER_EDGE = 1.3375
#: GB/s of the float32 band SpMM's priced bytes on the card
HBM_GBPS = 1234.92


class LayoutPlan(NamedTuple):
    """Outcome of :func:`plan_layout`.

    ``perm`` is ``perm[new] = old`` (the identity when reordering did not
    help); ``est_us`` maps each candidate form to its modelled µs an SpMM
    under the chosen ordering.
    """

    format: str  # "banded" | "hybrid" | "coo"
    perm: np.ndarray
    reordered: bool
    block: int
    bandwidth: int  # chosen W in blocks (0 for coo)
    remainder_frac: float  # fraction of edges outside the chosen band
    bandwidth_before: int  # node-index bandwidth, input ordering
    bandwidth_after: int  # node-index bandwidth, chosen ordering
    est_us: dict


def _band_cost_curve(
    dist_counts: np.ndarray,
    num_nodes: int,
    num_edges: int,
    *,
    block: int,
    feat: int,
    hbm_gbps: float,
    scatter_ns_per_edge: float,
    max_band_bytes: float,
    quantized: bool,
) -> tuple[np.ndarray, np.ndarray]:
    """Modelled seconds an SpMM for every band width W (in blocks).

    ``dist_counts[d]`` is the number of edges at block distance d.  Returns
    ``(cost_s[W], rem_edges[W])``, the cost ``inf`` where the band would
    not fit ``max_band_bytes``.
    """
    nb = round_up(num_nodes, block) // block
    padded = nb * block
    W = np.arange(dist_counts.shape[0], dtype=np.float64)
    in_band = np.cumsum(dist_counts).astype(np.float64)
    rem = num_edges - in_band

    band_bytes = nb * (2 * W + 1) * block * block * (1.0 if quantized else 4.0)
    x_bytes = (2 * W + 2) * padded * feat * (2.0 if quantized else 4.0)
    out_bytes = padded * feat * 4.0
    stream = (band_bytes + x_bytes + out_bytes) / (hbm_gbps * 1e9)
    cost = stream + rem * scatter_ns_per_edge * 1e-9
    cost = np.where(band_bytes <= max_band_bytes, cost, np.inf)
    return cost, rem


def _coo_cost(
    num_nodes: int, num_edges: int, *, feat: int, hbm_gbps: float,
    scatter_ns_per_edge: float,
) -> float:
    return (
        num_edges * scatter_ns_per_edge * 1e-9
        + 2.0 * num_nodes * feat * 4.0 / (hbm_gbps * 1e9)
    )


def _index_bandwidth(senders: np.ndarray, receivers: np.ndarray) -> int:
    if senders.size == 0:
        return 0
    return int(np.abs(senders.astype(np.int64) - receivers.astype(np.int64)).max())


def plan_layout(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    *,
    weights: Optional[np.ndarray] = None,
    block: int = 256,
    feat: int = 64,
    reorder: bool = True,
    spectral: bool | str = "auto",
    quantized: bool = False,
    max_band_gb: float = 8.0,
    hbm_gbps: float = HBM_GBPS,
    scatter_ns_per_edge: float = SCATTER_NS_PER_EDGE,
) -> LayoutPlan:
    """Choose the ordering and layout of a giant graph's SpMM.

    Prices every band width for the input ordering and (with ``reorder``)
    the RCM ordering, and returns the argmin over {banded, hybrid, coo}.
    ``quantized`` prices the int8 serving path (band ×¼, activations ×½)
    instead of float32.  ``max_band_gb`` bounds the band's device bytes: a
    candidate that does not fit is never chosen.

    ``spectral`` controls the spectral ordering: ``"auto"`` (the default)
    computes it only where the cheaper orderings leave more than 5 % of the
    edges out of band; ``True`` and ``False`` force or skip it.
    ``weights`` (optional) feed its objective.
    """
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    num_edges = int(senders.shape[0])
    bw_before = _index_bandwidth(senders, receivers)

    def eval_ordering(perm):
        if perm is None:
            s, r = senders, receivers
        else:
            inv = np.empty_like(perm)
            inv[perm] = np.arange(num_nodes)
            s, r = inv[senders], inv[receivers]
        dist = np.abs(s // block - r // block)
        counts = np.bincount(dist) if dist.size else np.zeros(1, np.int64)
        cost_s, rem = _band_cost_curve(
            counts, num_nodes, num_edges,
            block=block, feat=feat, hbm_gbps=hbm_gbps,
            scatter_ns_per_edge=scatter_ns_per_edge,
            max_band_bytes=max_band_gb * 1e9, quantized=quantized,
        )
        w = int(np.argmin(cost_s))
        rem_frac = float(rem[w]) / max(num_edges, 1)
        return (float(cost_s[w]) * 1e6, perm, w, rem_frac, s, r)

    candidates = [eval_ordering(None)]
    if reorder and num_edges:
        from connectome_gnn_tpu_torch.data.reorder import reverse_cuthill_mckee

        candidates.append(
            eval_ordering(reverse_cuthill_mckee(np.stack([senders, receivers]), num_nodes))
        )

    coo_us = _coo_cost(
        num_nodes, num_edges, feat=feat, hbm_gbps=hbm_gbps,
        scatter_ns_per_edge=scatter_ns_per_edge,
    ) * 1e6

    best = min(candidates, key=lambda c: c[0])
    want_spectral = spectral is True or (
        spectral == "auto" and reorder and num_edges
        and (best[3] > 0.05 or not np.isfinite(best[0]))
    )
    if want_spectral:
        from connectome_gnn_tpu_torch.data.reorder import spectral_ordering

        # every reweighting round is a candidate: the cost model, not the
        # eigensolver, judges which recovered the most bandable mass
        for perm_i in spectral_ordering(
            np.stack([senders, receivers]), num_nodes, weights, return_iterates=True,
        ):
            cand = eval_ordering(perm_i)
            if cand[0] < best[0]:
                best = cand

    cost_us, perm, w, rem_frac, s, r = best
    if coo_us <= cost_us or not np.isfinite(cost_us):
        fmt, w, rem_frac = "coo", 0, 1.0
    elif rem_frac == 0.0:
        fmt = "banded"
    else:
        fmt = "hybrid"

    reordered = perm is not None and fmt != "coo"
    if not reordered:
        perm = np.arange(num_nodes, dtype=np.int64)
        s, r = senders, receivers
    return LayoutPlan(
        format=fmt,
        perm=perm,
        reordered=reordered,
        block=block,
        bandwidth=w,
        remainder_frac=rem_frac,
        bandwidth_before=bw_before,
        bandwidth_after=_index_bandwidth(s, r),
        est_us={
            "chosen": min(cost_us, coo_us),
            "best_band_or_hybrid": cost_us,
            "coo": coo_us,
        },
    )


def build_layout(
    plan: LayoutPlan,
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    num_nodes: int,
    *,
    device=None,
):
    """Build the planned adjacency, relabelled by ``plan.perm``.

    Returns a :class:`~connectome_gnn_tpu_torch.ops.banded.BandedMatrix` or
    :class:`~connectome_gnn_tpu_torch.ops.banded.HybridMatrix`, or, for
    ``"coo"``, the receiver-sorted ``(senders, receivers, weights)``
    tensors for :func:`~connectome_gnn_tpu_torch.ops.segment.coo_spmm`, all
    on ``device``.  ``device`` defaults to ``cuda``, where the band
    accumulates (:func:`~connectome_gnn_tpu_torch.ops.banded.to_banded`);
    without a card that raises ``RuntimeError``.  On ``device="cpu"`` the
    band is the host build, bitwise the JAX package's.  Node-side arrays
    must be relabelled with ``array[plan.perm]`` to match.
    """
    from connectome_gnn_tpu_torch.ops.banded import to_banded, to_hybrid

    device = torch.device(card_by_default(device, "build_layout"))
    band_device = None if device.type == "cpu" else device
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    weights = np.asarray(weights, np.float32)
    if plan.reordered:
        inv = np.empty_like(plan.perm)
        inv[plan.perm] = np.arange(num_nodes)
        senders, receivers = inv[senders], inv[receivers]

    if plan.format == "banded":
        return to_banded(senders, receivers, weights, num_nodes,
                         block=plan.block, bandwidth=plan.bandwidth, device=band_device)
    if plan.format == "hybrid":
        return to_hybrid(senders, receivers, weights, num_nodes,
                         block=plan.block, bandwidth=plan.bandwidth, device=band_device)
    order = np.argsort(receivers, kind="stable")
    return tuple(torch.from_numpy(a[order]).to(device) for a in (senders, receivers, weights))


def auto_layout(
    graph,
    *,
    block: int = 256,
    feat: Optional[int] = None,
    reorder: bool = True,
    quantized: bool = False,
    max_band_gb: float = 8.0,
    device=None,
):
    """Plan, reorder and build in one call, for a
    :class:`~connectome_gnn_tpu_torch.data.graph.ConnectomeGraph`.

    Returns ``(adjacency, reordered_graph, plan)``: ``adjacency`` as
    :func:`build_layout` returns it (on ``device``, which defaults to
    ``cuda`` and raises ``RuntimeError`` without a card), ``reordered_graph``
    with features and edges relabelled by the chosen permutation (the
    graph itself when no reordering won).
    """
    from connectome_gnn_tpu_torch.data.reorder import apply_ordering

    device = card_by_default(device, "auto_layout")

    senders, receivers = graph.edge_index[0], graph.edge_index[1]
    plan = plan_layout(
        senders, receivers, graph.num_nodes,
        weights=graph.edge_weight,
        block=block,
        feat=feat if feat is not None else int(graph.node_features.shape[1]),
        reorder=reorder, quantized=quantized, max_band_gb=max_band_gb,
    )
    adj = build_layout(plan, senders, receivers, graph.edge_weight, graph.num_nodes, device=device)
    g2 = apply_ordering(graph, plan.perm) if plan.reordered else graph
    return adj, g2, plan
