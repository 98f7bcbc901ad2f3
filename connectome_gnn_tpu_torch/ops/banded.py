"""Banded block-dense SpMM for giant spatially-local graphs.

The port of ``connectome_gnn_tpu/ops/banded.py``.  After a spatial or
Reverse-Cuthill-McKee ordering every edge of a voxel-level connectome links
nodes a bounded index distance apart, so the sparse matrix is a **block
band**:

    band[rb, d] = dense (block × block) tile of
                  A[rb·block : (rb+1)·block, (rb+d-W)·block : (rb+d-W+1)·block]

and SpMM is ``out[rb] = Σ_d band[rb, d] @ x_blocks[rb + d - W]``.  Tiles are
receiver-major: ``band[rb, d, i, j]`` is the weight of edge ``(sender =
(rb+d-W)·block + j) → (receiver = rb·block + i)``.

The JAX package leaves the f32 band SpMM to XLA's einsum, so here it is
plain torch (:func:`banded_spmm`, also the oracle of the int8 kernels in
:mod:`connectome_gnn_tpu_torch.ops.banded_quant`), with the JAX package's
custom backward ``x̄ = Aᵀ·ȳ`` one diagonal at a time.  The hybrid form
routes the out-of-band shortcuts of small-world graphs through the COO
scatter path (:func:`hybrid_spmm`).  :func:`banded_block_diag` and
:func:`hybrid_block_diag` concatenate a cohort of graphs block-diagonally:
the single-device oracle of the 2-D (data × edge) sharded step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from connectome_gnn_tpu_torch.data.batch import round_up
from connectome_gnn_tpu_torch.ops.segment import coo_spmm, segment_sum


class BandedMatrix(NamedTuple):
    """Block-banded sparse matrix.

    ``band`` is ``[NB, 2W+1, block, block]`` (float32); ``num_nodes`` is the
    unpadded logical dimension; the padded dimension is ``NB · block``.
    """

    band: torch.Tensor
    num_nodes: int
    bandwidth: int  # W, in blocks

    @property
    def block(self) -> int:
        return int(self.band.shape[2])

    @property
    def num_blocks(self) -> int:
        return int(self.band.shape[0])


def to_banded(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    num_nodes: int,
    *,
    block: int = 256,
    bandwidth: Optional[int] = None,
    device=None,
) -> BandedMatrix:
    """Convert a COO edge list to block-banded form.

    ``bandwidth`` (in blocks) defaults to the smallest band containing every
    edge; an edge outside an explicitly given band raises ``ValueError``
    (reorder the graph first).  Duplicate edges accumulate additively.

    With ``device`` unset the band is built on the host, by the native
    helper (:func:`connectome_gnn_tpu_torch.native.band_pack`) where it is
    built and ``np.add.at`` otherwise, bitwise equal to the JAX package's.
    With a ``device`` it accumulates
    there, by ``index_put_(accumulate=True)`` over linear tile indices: at a
    million nodes the host build of a 5.4 GB band and its pageable copy
    take far longer than the card's scatter.  Duplicate edges then add in
    the device's order.
    """
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    weights = np.asarray(weights, np.float32)

    padded = round_up(num_nodes, block)
    nb = padded // block
    rb = receivers // block
    d = senders // block - rb
    if bandwidth is None:
        bandwidth = int(np.abs(d).max()) if d.size else 0
    elif d.size and np.abs(d).max() > bandwidth:
        raise ValueError(
            f"edge outside band: |block distance| {int(np.abs(d).max())} > "
            f"bandwidth {bandwidth}; reorder the graph (e.g. RCM) first"
        )
    W = int(bandwidth)
    D = 2 * W + 1

    if device is None:
        from connectome_gnn_tpu_torch import native

        band = np.zeros((nb, D, block, block), np.float32)
        if native.AVAILABLE:
            native.band_pack(senders, receivers, weights, band, W)
        else:
            np.add.at(band, (rb, d + W, receivers % block, senders % block), weights)
        return BandedMatrix(torch.from_numpy(band), int(num_nodes), W)

    lin = ((rb * D + d + W) * block + receivers % block) * block + senders % block
    band = torch.zeros(nb * D * block * block, dtype=torch.float32, device=device)
    band.index_put_(
        (torch.from_numpy(lin).to(device),),
        torch.from_numpy(weights).to(device),
        accumulate=True,
    )
    return BandedMatrix(band.view(nb, D, block, block), int(num_nodes), W)


def pad_blocks(x: torch.Tensor, num_blocks: int, bandwidth: int, block: int) -> torch.Tensor:
    """Node-major ``x [n, F]`` in the W-shifted padded frame, as blocks
    ``[NB + 2W, block, F]``: block ``w`` holds nodes ``(w - W)·block ...``,
    zeros outside ``[0, n)``.  Window ``d`` of row block ``rb`` is block
    ``rb + d``."""
    n, F = x.shape
    x_pad = x.new_zeros(((num_blocks + 2 * bandwidth) * block, F))
    x_pad[bandwidth * block : bandwidth * block + n] = x
    return x_pad.view(num_blocks + 2 * bandwidth, block, F)


class _BandWindows(torch.autograd.Function):
    """``out[..., rb] = Σ_d band[..., rb, d] @ x_ext[..., rb + d]``: a band
    ``[..., NB, 2W+1, b, b]`` times its blocks extended by ``W`` a side,
    ``x_ext [..., NB + 2W, b, F]``, one batched matmul per diagonal with
    every leading axis folded into its batch; ``[..., NB, b, F]``.  The
    backward is the JAX package's (``connectome_gnn_tpu/ops/banded.py:164-208``):
    it saves only the band and adds ``band[..., d]ᵀ · ȳ`` into the blocks
    ``d … d + NB - 1``, one batched matmul and one static slice-add a
    diagonal.  The band, training data and not a parameter, gets no
    gradient.  A band stored bfloat16 is widened one diagonal at a time."""

    @staticmethod
    def forward(ctx, band: torch.Tensor, x_ext: torch.Tensor) -> torch.Tensor:
        nb, D, block = band.shape[-4:-1]
        F = x_ext.shape[-1]
        out = x_ext.new_zeros((*band.shape[:-4], nb, block, F))
        flat = out.view(-1, block, F)
        for d in range(D):
            a = band[..., d, :, :].to(x_ext.dtype).reshape(-1, block, block)
            flat += torch.bmm(a, x_ext[..., d : d + nb, :, :].reshape(-1, block, F))
        ctx.save_for_backward(band)
        ctx.ext_shape = x_ext.shape
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (band,) = ctx.saved_tensors
        nb, D, block = band.shape[-4:-1]
        F = g.shape[-1]
        g_flat = g.reshape(-1, block, F)
        grad = g.new_zeros(ctx.ext_shape)
        for d in range(D):
            a = band[..., d, :, :].to(g.dtype).reshape(-1, block, block).transpose(1, 2)
            grad[..., d : d + nb, :, :] += torch.bmm(a, g_flat).view(g.shape)
        return None, grad


def band_windows(band: torch.Tensor, x_ext: torch.Tensor) -> torch.Tensor:
    """``Σ_d band[..., rb, d] @ x_ext[..., rb + d]`` over blocks extended
    by ``W`` a side (:class:`_BandWindows`): the core of
    :func:`banded_spmm` (zero-padded blocks) and of the sharded band
    models (halo-extended blocks, a leading shard axis)."""
    return _BandWindows.apply(band, x_ext)


def banded_spmm(a: BandedMatrix, x: torch.Tensor) -> torch.Tensor:
    """``out = A @ x`` over the block band in float32; ``[num_nodes, F]``.

    One batched matmul per diagonal over the shifted block windows
    (:func:`band_windows`).  A band stored bfloat16
    (:meth:`BandedNodeGCN.prepare`) is widened one diagonal at a time, with
    float32 accumulation, as the JAX einsum does.  Differentiable in ``x``
    through the JAX package's custom backward, which holds only the band;
    rows of ``x`` past ``num_nodes`` get zeros.
    """
    nb, _, block, _ = a.band.shape
    xb = pad_blocks(x[: a.num_nodes].to(torch.float32), nb, a.bandwidth, block)
    return band_windows(a.band, xb).reshape(nb * block, -1)[: a.num_nodes]


def transpose_banded(a: BandedMatrix) -> BandedMatrix:
    """``Aᵀ`` in banded form (same block size and bandwidth), bitwise equal
    to the JAX package's: ``bandT[cb, d] = band[cb + d - W, 2W - d]ᵀ``,
    and zero where ``cb + d - W`` falls off either edge."""
    return BandedMatrix(_shift_diagonals(a.band, transpose_tiles=True), a.num_nodes, a.bandwidth)


def _shift_diagonals(t: torch.Tensor, *, fill=0, transpose_tiles: bool = False) -> torch.Tensor:
    """The diagonal geometry of ``Aᵀ`` for any per-(row block, diagonal)
    array ``t [NB, 2W+1, ...]``: ``out[cb, d] = t[cb + d - W, 2W - d]``
    (each tile transposed with ``transpose_tiles``), and ``fill`` where the
    source row block is off the band."""
    nb, D = t.shape[:2]
    W = (D - 1) // 2
    out = torch.full_like(t, fill)
    for d in range(D):
        shift = d - W  # source row block = cb + shift
        rows = nb - abs(shift)
        if rows <= 0:
            continue
        src = t[max(shift, 0) : max(shift, 0) + rows, 2 * W - d]
        out[max(-shift, 0) : max(-shift, 0) + rows, d] = src.transpose(1, 2) if transpose_tiles else src
    return out


def banded_row_sum(a: BandedMatrix) -> torch.Tensor:
    """Weighted receiver (row) degrees, ``[padded]`` — the SAGE mean
    normalizer (rows are local to their block, no halo needed)."""
    return a.band.sum(dim=(1, 3)).reshape(a.num_blocks * a.block)


def banded_sender_degree(a: BandedMatrix) -> torch.Tensor:
    """Weighted sender (column) degrees, ``[padded]``.

    Column ``cb·block + j`` collects from every row block ``rb`` with
    ``cb = rb + d - W``: a block-level shift-add per diagonal in the
    W-padded frame, whose halo blocks are then dropped."""
    block, nb, W = a.block, a.num_blocks, a.bandwidth
    col_sums = a.band.sum(dim=2)  # [NB, 2W+1, block], over receivers i
    deg_blocks = col_sums.new_zeros((nb + 2 * W, block))
    for d in range(2 * W + 1):
        deg_blocks[d : d + nb] += col_sums[:, d]
    return deg_blocks[W : W + nb].reshape(nb * block)


def _scale_band(a: BandedMatrix, dinv: torch.Tensor) -> BandedMatrix:
    """Rescale band entries by ``dinv[receiver] · w · dinv[sender]``.

    The sender side takes ``dinv`` through the same halo-window indexing as
    the SpMM (zero outside the padded range).  The second product runs in
    place, so the peak is the source band and one band-sized result."""
    block, nb, W = a.block, a.num_blocks, a.bandwidth
    dinv_rows = dinv.view(nb, 1, block, 1)
    dinv_pad = torch.cat([dinv.new_zeros(W * block), dinv, dinv.new_zeros(W * block)])
    idx = (
        torch.arange(nb, device=dinv.device)[:, None]
        + torch.arange(2 * W + 1, device=dinv.device)[None, :]
    )
    dinv_cols = dinv_pad.view(nb + 2 * W, block)[idx][:, :, None, :]
    band = dinv_rows * a.band
    band.mul_(dinv_cols)
    return BandedMatrix(band, a.num_nodes, W)


def gcn_normalize_banded(
    a: BandedMatrix, *, self_loop_weight: float = 1.0, eps: float = 1e-8
) -> tuple[BandedMatrix, torch.Tensor]:
    """Symmetric GCN normalization of a banded adjacency.

    Returns the normalized band and ``dinv [padded]``: sender degrees plus
    the self-loop weight, ``(deg + 1e-8)^-0.5``, as
    :func:`~connectome_gnn_tpu_torch.ops.gcn_norm.gcn_normalize`.  Padded
    node slots get ``deg = self_loop_weight`` and stay inert.
    """
    deg = banded_sender_degree(a) + self_loop_weight
    dinv = torch.rsqrt(deg + eps)
    return _scale_band(a, dinv), dinv


def banded_block_diag(parts) -> tuple[BandedMatrix, torch.Tensor]:
    """Block-diagonal concatenation of banded matrices
    (``connectome_gnn_tpu/ops/banded.py:297``).

    Out-of-range band entries are zero by construction, so stacking the
    parts' bands along the block-row axis is the block-diagonal matrix: a
    part's boundary blocks reach its neighbor only through all-zero tiles.
    Returns ``(combined, node_valid_mask)``; the mask is False on each
    part's padding rows (``num_nodes .. padded``), which callers must also
    zero in the concatenated features.  All parts must share ``block`` and
    ``bandwidth``.
    """
    blocks = {p.block for p in parts}
    widths = {p.bandwidth for p in parts}
    if len(blocks) != 1 or len(widths) != 1:
        raise ValueError("banded_block_diag requires uniform block/bandwidth")
    band = torch.cat([p.band for p in parts], dim=0)
    valid = torch.cat([
        torch.arange(p.num_blocks * p.block, device=band.device) < p.num_nodes for p in parts
    ])
    return BandedMatrix(band, int(band.shape[0]) * int(band.shape[2]), widths.pop()), valid


class HybridMatrix(NamedTuple):
    """Band plus sparse remainder: the local bulk in a band, the long-range
    shortcuts of a small-world graph as COO.

    The remainder arrays are padded to a static length, receiver-sorted,
    with padding ids one past the end (``NB · block``) and weight 0, the
    conventions of :class:`~connectome_gnn_tpu_torch.data.batch.
    ConnectomeBatch`.  Index tensors are ``int64``; their values equal the
    JAX package's ``int32`` arrays.
    """

    band: BandedMatrix
    remainder_senders: torch.Tensor
    remainder_receivers: torch.Tensor
    remainder_weights: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.band.num_nodes


def to_hybrid(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    num_nodes: int,
    *,
    block: int = 256,
    bandwidth: int = 4,
    edge_multiple: int = 128,
    device=None,
) -> HybridMatrix:
    """Split a COO edge list into a ±``bandwidth``-block band plus a sparse
    remainder.  The split runs on the host; the band is built on ``device``
    as :func:`to_banded` builds it."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    weights = np.asarray(weights, np.float32)

    d = senders // block - receivers // block
    in_band = np.abs(d) <= bandwidth
    band = to_banded(
        senders[in_band], receivers[in_band], weights[in_band], num_nodes,
        block=block, bandwidth=bandwidth, device=device,
    )

    rem_s = senders[~in_band]
    rem_r = receivers[~in_band]
    rem_w = weights[~in_band]
    order = np.argsort(rem_r, kind="stable")
    e = rem_s.shape[0]
    padded = band.num_blocks * block
    cap = round_up(max(e, 1), edge_multiple)
    out_s = np.full(cap, padded, np.int64)
    out_r = np.full(cap, padded, np.int64)
    out_w = np.zeros(cap, np.float32)
    out_s[:e] = rem_s[order]
    out_r[:e] = rem_r[order]
    out_w[:e] = rem_w[order]
    dev = band.band.device
    return HybridMatrix(
        band,
        torch.from_numpy(out_s).to(dev),
        torch.from_numpy(out_r).to(dev),
        torch.from_numpy(out_w).to(dev),
    )


def hybrid_block_diag(parts) -> tuple[HybridMatrix, torch.Tensor]:
    """Block-diagonal concatenation of hybrid matrices
    (``connectome_gnn_tpu/ops/banded.py:398``): the bands stack as in
    :func:`banded_block_diag`; each part's real remainder edges are offset
    by the part's padded start, and the combined list is receiver-sorted
    and padded again (a part's padding ids point at its own padded end and
    would alias the next part's rows).  Returns ``(combined,
    node_valid_mask)``."""
    band, valid = banded_block_diag([p.band for p in parts])
    ss, rr, ww = [], [], []
    off = 0
    for p in parts:
        padded = p.band.num_blocks * p.band.block
        s = p.remainder_senders.cpu().numpy().astype(np.int64)
        r = p.remainder_receivers.cpu().numpy().astype(np.int64)
        w = p.remainder_weights.cpu().numpy().astype(np.float32)
        real = r < padded
        ss.append(s[real] + off)
        rr.append(r[real] + off)
        ww.append(w[real])
        off += padded
    s = np.concatenate(ss) if ss else np.empty(0, np.int64)
    r = np.concatenate(rr) if rr else np.empty(0, np.int64)
    w = np.concatenate(ww) if ww else np.empty(0, np.float32)
    order = np.argsort(r, kind="stable")
    e = s.shape[0]
    cap = round_up(max(e, 1), 128)
    out_s = np.full(cap, off, np.int64)
    out_r = np.full(cap, off, np.int64)
    out_w = np.zeros(cap, np.float32)
    out_s[:e] = s[order]
    out_r[:e] = r[order]
    out_w[:e] = w[order]
    dev = band.band.device
    return (
        HybridMatrix(band, torch.from_numpy(out_s).to(dev), torch.from_numpy(out_r).to(dev),
                     torch.from_numpy(out_w).to(dev)),
        valid,
    )


def remainder_spmm(a, x: torch.Tensor, *, remainder_chunk: Optional[int] = None) -> torch.Tensor:
    """The COO remainder's share of ``A @ x``, ``[num_nodes, F]``, in
    slices of ``remainder_chunk`` edges where that is given
    (:func:`~connectome_gnn_tpu_torch.ops.segment.coo_spmm`'s
    ``edge_chunk``)."""
    n = a.num_nodes
    return coo_spmm(
        a.remainder_weights, a.remainder_senders, a.remainder_receivers,
        x[:n].to(torch.float32), n, edge_chunk=remainder_chunk,
    )


def hybrid_spmm(
    a: HybridMatrix, x: torch.Tensor, *, remainder_chunk: Optional[int] = None
) -> torch.Tensor:
    """``A @ x`` for the hybrid form: banded bulk plus scatter remainder.

    ``remainder_chunk`` bounds the device memory of a giant remainder: its
    gathered messages take ``E·F·4`` bytes at once without it.
    """
    return banded_spmm(a.band, x) + remainder_spmm(a, x, remainder_chunk=remainder_chunk)


def hybrid_row_sum(a: HybridMatrix) -> torch.Tensor:
    """Weighted receiver (row) degrees over band and remainder, ``[padded]``."""
    row = banded_row_sum(a.band)
    return row + segment_sum(a.remainder_weights, a.remainder_receivers, row.shape[0])


def hybrid_sender_degree(a: HybridMatrix) -> torch.Tensor:
    """Weighted sender degrees over band and remainder, ``[padded]``."""
    deg = banded_sender_degree(a.band)
    return deg + segment_sum(a.remainder_weights, a.remainder_senders, deg.shape[0])


def gcn_normalize_hybrid(
    a: HybridMatrix, *, self_loop_weight: float = 1.0, eps: float = 1e-8
) -> tuple[HybridMatrix, torch.Tensor]:
    """Symmetric GCN normalization of a hybrid adjacency: sender degrees
    (plus the self-loop) over both parts, ``(deg + 1e-8)^-0.5``, and a
    per-entry rescale of each."""
    deg = hybrid_sender_degree(a) + self_loop_weight
    dinv = torch.rsqrt(deg + eps)
    band_norm = _scale_band(a.band, dinv)
    # padding ids point one past the end; clamp for the gather (weight 0)
    last = deg.shape[0] - 1
    rem_norm = (
        dinv[a.remainder_receivers.clamp(max=last)]
        * a.remainder_weights
        * dinv[a.remainder_senders.clamp(max=last)]
    )
    return (
        HybridMatrix(band_norm, a.remainder_senders, a.remainder_receivers, rem_norm),
        dinv,
    )
