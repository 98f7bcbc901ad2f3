"""Operands and launches of the tensor-core band body, ``csrc/band_mma.cu``.

That body serves K3, K4, K5, K6, B2b, B2c, B3a ``fm_w8a8`` and
``fm_dma_only``, B3b, B3c and B3d over the int8 band, K7 over a float32 or
bfloat16 band, and B2a and B3a ``fm_bf16_band`` over a bfloat16 band.
Role A is row-major:
``out[rb·b + r] = Σ_d scale[rb, d] · (tile[rb, d] @ x̂[rb + d])`` for the
int8 band with its per-tile scales (widened to bfloat16 in the kernel's
registers, which is exact; with B2c's ``wrow_bf16`` each scale is folded
into its tile instead, rounded to bfloat16 as the plain version does), and
without scales for a bfloat16 band (K7, B2a) and a float32 band (K7), whose
every value the kernel splits exactly into three bfloat16 terms, as
:func:`split_bf16x3` splits ``x`` into three frames.  Role B is
feature-major, with per-dot scales: B3a's ``fm_bf16_band`` over a bfloat16
band and frame, and K4, K6, B3c and B3d over the int8 band, which the
kernel widens to bfloat16 in shared memory.  K4 and K6 take float32 ``x``,
which the kernel rounds to bfloat16 in registers (K4 reads the caller's
``xT`` itself, K6 its blocked padded frame); B3c and B3d take the bfloat16
frame their TPU functions take (B3c B3a's feature-major one, B3d a blocked
one).  K5 takes role A's schedule over the int8 band of transposed tiles
and an int8 frame (:func:`fm_frame` of K5's quantized activations) with one
scale a frame block, on ``s8 × s8`` products exact in int32
(:func:`launch_w8a8`; B3a's ``fm_w8a8`` is that launch on its caller's
operands).  B2b takes role A over the int8 band of receiver-major tiles on
the same products and K5's int8 frame, which its wrapper builds
feature-major from the node-major quantization (:func:`w8a8_fm_frame`),
and stores node-major (:func:`launch_rowmajor_w8a8`).  B3b takes role B's
on a bfloat16 window, walking one panel of the band for every chunk
(:func:`launch_panel`).  B3a's ``fm_dma_only`` stages what B3d stages,
on role B's ring over the int8 band and the bfloat16 feature-major frame,
and computes no dot: its consumers add frame block ``rb``'s ``x`` and
diagonal 0's tile rows from two stages and release the others untouched
(:func:`launch_dma_only`).  Its products
are ``wgmma`` on tiles staged by TMA, and TMA needs 16-byte global
strides.  So the wrappers hand it the band and the frame
padded with zeros where they are not: the block to ``b' = ⌈b/16⌉·16`` and,
in role A, the features to ``F' = ⌈F/8⌉·8``; K4's, K6's and B3d's ``x`` is
copied once, padded, where its block is not a multiple of 16, its row
stride not a multiple of 4 elements (K4) or its base not 16-byte aligned
(:func:`fm_x_operand`, :func:`blocked_x_operand`).  Zero senders and
receivers change no sum; the kernel stores only the caller's ``b``
receivers a block and ``F`` features.  At the main shape (``b = 256``,
``F = 64``) nothing is padded or copied.

``x̂`` is ``x[:num_nodes]`` in the W-shifted padded frame, rounded to
bfloat16 (round to nearest even), as ``connectome_gnn_tpu/ops/banded_pallas.py``
and ``banded_quant.py`` hand it to their ``pallas_call``s, or, for the
float32 band, split into its three bfloat16 terms:
:func:`rowmajor_frame` builds either at the main shape in one pass over
``x`` (three for the split).  :func:`rowmajor_on_operands` and
:func:`fm_on_operands` compute the kernel's function on the prepared
operands in plain torch (with :func:`fm_window_frame`, the frame as K4's
tensor map reads it), :func:`w8a8_on_operands` K5's,
:func:`rowmajor_w8a8_on_operands` B2b's and :func:`dma_only_on_operands`
B3a dma-only's, so the tests can hold the padding and the layout against
the plain versions on the original operands.
The launches here count nothing; their callers count.
"""

from __future__ import annotations

import torch

from connectome_gnn_tpu_torch.ops.banded import BandedMatrix
from connectome_gnn_tpu_torch.ops.banded_quant import _launch, _stream

#: TMA reads 16-byte rows: the wrappers pad the block to a multiple of this
BLOCK_MULTIPLE = 16
#: ... and role A's node-major frame to a multiple of this many features
FEATURE_MULTIPLE = 8


def padded(size: int, multiple: int) -> int:
    return -(-size // multiple) * multiple


def pad_band(band: torch.Tensor) -> torch.Tensor:
    """``[NB, D, b, b]`` → ``[NB, D, b', b']`` with zeros past ``b``; the
    band itself when ``b`` is a multiple of 16."""
    b = band.shape[2]
    bp = padded(b, BLOCK_MULTIPLE)
    if bp == b:
        return band
    out = band.new_zeros((*band.shape[:2], bp, bp))
    out[:, :, :b, :b] = band
    return out


#: the products of the float32 band's split a k-step, as (band term, x
#: term) with 0 = hi, 1 = mid, 2 = lo, in the kernel's order: the five small
#: ones (into a fragment of their own), then hi·hi (into the tile's dot).
#: Left out: mid·lo, lo·mid and lo·lo, each under 2^-24 of the product.
SPLIT_PRODUCTS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def split_bf16x3(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """A float32 ``x`` split exactly into three bfloat16 terms, ``[3, *x.shape]``:
    ``hi = rn(x)``, ``mid = rn(x - hi)``, ``lo = x - hi - mid`` (round to
    nearest even), so ``hi + mid + lo == x``; the kernel splits the float32
    band in its registers the same way.  Both subtractions are exact in
    float32 and ``lo`` has at most 8 significant bits, for every finite ``x``
    up to bfloat16's largest finite value (3.39e38) and down to about
    2^-110 in magnitude (and 0).  Written into ``out`` where given."""
    if out is None:
        out = torch.empty((3, *x.shape), dtype=torch.bfloat16, device=x.device)
    out[0].copy_(x)
    rest = x - out[0]
    out[1].copy_(rest)
    rest -= out[1]
    out[2].copy_(rest)
    return out


def rowmajor_frame(x: torch.Tensor, num_nodes: int, num_blocks: int, bandwidth: int,
                   block: int, split: bool = False) -> torch.Tensor:
    """``x[:num_nodes]`` rounded to bfloat16 in the W-shifted padded frame,
    ``[NB + 2W, b', F']``: frame block ``w`` holds nodes ``(w - W)·b ...``,
    zeros elsewhere.  Without padding it is ``banded_pallas.py:45-48``'s
    ``x_pad``, built by one cast-and-copy and zeroing only the halo.  With
    ``split``, the three frames of :func:`split_bf16x3`, ``[3, NB + 2W, b',
    F']``, for the float32 band."""
    n, F = num_nodes, x.shape[1]
    bp, Fp = padded(block, BLOCK_MULTIPLE), padded(F, FEATURE_MULTIPLE)
    blocks, parts = num_blocks + 2 * bandwidth, (3,) if split else ()
    if (bp, Fp) == (block, F):
        frame = torch.empty((*parts, blocks * block, F), dtype=torch.bfloat16, device=x.device)
        lo = bandwidth * block
        frame[..., :lo, :].zero_()
        frame[..., lo + n :, :].zero_()
        if split:
            split_bf16x3(x[:n], out=frame[:, lo : lo + n])
        else:
            frame[lo : lo + n] = x[:n]
        return frame.view(*parts, blocks, block, F)
    nodes = torch.zeros((num_blocks * block, F), dtype=x.dtype, device=x.device)
    nodes[:n] = x[:n]
    nodes = split_bf16x3(nodes) if split else nodes.to(torch.bfloat16)
    frame = torch.zeros((*parts, blocks, bp, Fp), dtype=torch.bfloat16, device=x.device)
    frame[..., bandwidth : bandwidth + num_blocks, :block, :F] = nodes.view(*parts, num_blocks, block, F)
    return frame


def rowmajor_operands(a: BandedMatrix, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Role A's operands of a bfloat16 or float32 band: the band and ``x̂``
    (split into three frames for the float32 band), padded."""
    split = a.band.dtype == torch.float32
    return pad_band(a.band), rowmajor_frame(x, a.num_nodes, a.num_blocks, a.bandwidth, a.block, split)


def fold_bf16(band_q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """B2c's tiles with ``wrow_bf16``: ``fl(scale · float(q))`` in float32,
    rounded to bfloat16, as its plain version folds them and the kernel
    folds each tile entry while it widens it."""
    return (scales[:, :, None, None] * band_q.to(torch.float32)).to(torch.bfloat16)


def fm_frame(x_pad: torch.Tensor, num_blocks: int, bandwidth: int, block: int) -> torch.Tensor:
    """The bfloat16 feature-major frame ``[F, (NB + 2W)·b]`` with each block
    padded to ``b'`` senders, ``[F, (NB + 2W)·b']``; itself when ``b' = b``."""
    bp = padded(block, BLOCK_MULTIPLE)
    if bp == block:
        return x_pad
    F, blocks = x_pad.shape[0], num_blocks + 2 * bandwidth
    out = x_pad.new_zeros((F, blocks, bp))
    out[:, :, :block] = x_pad.view(F, blocks, block)
    return out.view(F, blocks * bp)


def rowmajor_on_operands(band_p: torch.Tensor, frame: torch.Tensor, num_nodes: int, W: int,
                         block: int, F: int, scales: torch.Tensor | None = None,
                         wrow_bf16: bool = False) -> torch.Tensor:
    """Role A's function on its prepared operands, in plain torch:
    ``[num_nodes, F]`` float32.  Each tile's dot times its scale where
    ``scales [NB, 2W+1]`` is given (the int8 band), or with the scales
    folded into the tiles (:func:`fold_bf16`) with ``wrow_bf16``.  A float32
    band and its three frames give the sum of the :data:`SPLIT_PRODUCTS`,
    summed in float64 so that no float32 sum order enters, rounded to
    float32 once."""
    nb = band_p.shape[0]
    if band_p.dtype == torch.float32:
        parts = split_bf16x3(band_p).to(torch.float64)
        xw = frame.to(torch.float64)
        out = xw.new_zeros((nb, band_p.shape[2], xw.shape[3]))
        for d in range(2 * W + 1):
            for i, j in SPLIT_PRODUCTS:
                out += torch.bmm(parts[i][:, d], xw[j][d : d + nb])
        return out[:, :block, :F].reshape(nb * block, F)[:num_nodes].to(torch.float32)
    if wrow_bf16:
        band_p, scales = fold_bf16(band_p, scales), None
    xw = frame.to(torch.float32)
    out = xw.new_zeros((nb, band_p.shape[2], xw.shape[2]))
    for d in range(2 * W + 1):
        dot = torch.bmm(band_p[:, d].to(torch.float32), xw[d : d + nb])
        out += dot if scales is None else scales[:, d, None, None] * dot
    return out[:, :block, :F].reshape(nb * block, F)[:num_nodes]


def fm_x_operand(xT: torch.Tensor, num_nodes: int, num_blocks: int,
                 block: int) -> tuple[torch.Tensor, int, int]:
    """K4's float32 activations as its 2-D tensor map reads them: ``(x,
    x_block, x_cols)``, sender ``v`` of node block ``j`` at column ``j ·
    x_block + v`` of ``x``'s first ``x_cols`` columns, zero fill past them.
    The caller's ``xT [F, ≥num_nodes]`` itself (``x_block = b``, ``x_cols =
    num_nodes``) where ``b`` is a multiple of 16 and TMA takes its rows (a
    row stride that is a multiple of 4 elements, a 16-byte aligned base);
    else one zero-padded copy ``[F, NB·b']``."""
    bp, ld = padded(block, BLOCK_MULTIPLE), xT.stride(0)
    if bp == block and ld % 4 == 0 and ld >= num_nodes and xT.data_ptr() % 16 == 0:
        return xT, block, num_nodes
    F = xT.shape[0]
    nodes = xT.new_zeros((F, num_blocks * block))
    nodes[:, :num_nodes] = xT[:, :num_nodes]
    x = xT.new_zeros((F, num_blocks, bp))
    x[:, :, :block] = nodes.view(F, num_blocks, block)
    return x.view(F, num_blocks * bp), bp, num_blocks * bp


def blocked_x_operand(xb_pad: torch.Tensor, block: int) -> torch.Tensor:
    """K6's float32 (or B3d's bfloat16) padded blocked frame ``[NB + 2W, F,
    b]`` as its 3-D tensor map reads it, ``[NB + 2W, F, b']``: itself where
    ``b' = b`` and its base is 16-byte aligned, else a zero-padded copy."""
    bp = padded(block, BLOCK_MULTIPLE)
    if bp == block and xb_pad.data_ptr() % 16 == 0:
        return xb_pad
    out = xb_pad.new_zeros((*xb_pad.shape[:2], bp))
    out[..., :block] = xb_pad
    return out


def fm_window_frame(x: torch.Tensor, x_block: int, x_cols: int, num_blocks: int, W: int,
                    block_pad: int) -> torch.Tensor:
    """The W-shifted padded frame ``[F, (NB + 2W)·b']`` that K4's map gives
    the kernel from :func:`fm_x_operand`'s operands: sender ``s < b'`` of
    frame block ``w`` is column ``(w - W)·x_block + s`` of ``x``, zero
    outside ``[0, x_cols)``."""
    cols = ((torch.arange(num_blocks + 2 * W)[:, None] - W) * x_block
            + torch.arange(block_pad)[None, :]).reshape(-1).to(x.device)
    inside = (cols >= 0) & (cols < x_cols)
    frame = x[:, cols.clamp(0, x_cols - 1)]
    return torch.where(inside, frame, torch.zeros((), dtype=x.dtype, device=x.device))


def fm_on_operands(band_p: torch.Tensor, scales: torch.Tensor, x_pad_p: torch.Tensor, W: int,
                   block: int) -> torch.Tensor:
    """Role B's function on its prepared operands, in plain torch:
    ``[F, NB·block]`` float32.  The frame is rounded to bfloat16 first (a
    no-op for the bfloat16 frames of B3a, B3c and B3d; K4's and K6's float32
    ``x``, as the kernel rounds it in registers); an int8 band is exact in
    float32.  Where nothing is padded it is the plain versions' arithmetic
    op for op (``banded_quant._windows_times_band``), so bit for bit."""
    nb, bp, F = band_p.shape[0], band_p.shape[2], x_pad_p.shape[0]
    xw = x_pad_p.to(torch.bfloat16).to(torch.float32).view(F, nb + 2 * W, bp)
    xw = xw.permute(1, 0, 2).contiguous()
    out = xw.new_zeros((nb, F, bp))
    for d in range(2 * W + 1):
        out += scales[:, d, None, None] * torch.bmm(xw[d : d + nb], band_p[:, d].to(torch.float32))
    return out[:, :, :block].permute(1, 0, 2).reshape(F, nb * block)


def dma_only_on_operands(band_p: torch.Tensor, frame_p: torch.Tensor, num_nodes: int, W: int,
                         block: int, F: int) -> torch.Tensor:
    """B3a dma-only's function on its prepared operands (the padded int8
    band of transposed tiles and :func:`fm_frame`'s bfloat16 frame ``[F,
    (NB + 2W)·b']``), in plain torch: ``[F, num_nodes]`` float32, column
    ``rb·b + c`` the sum of frame block ``rb``'s sender ``c`` (the padded
    frame, not shifted back) and row ``f`` of tile ``(rb, 0)`` at receiver
    ``c``.  It reads only what the kernel's stores take: the first ``b`` of
    the ``b'`` senders of frame blocks ``0 .. NB - 1`` and receivers of
    diagonal 0's tiles, and those tiles' first ``F ≤ b`` rows; ``F`` is the
    frame's features."""
    nb, bp = band_p.shape[0], band_p.shape[2]
    x = frame_p[:F].view(F, nb + 2 * W, bp)[:, :nb, :block].to(torch.float32)
    rows = band_p[:, 0, :F, :block].to(torch.float32).transpose(0, 1)
    return (x + rows).reshape(F, nb * block)[:, :num_nodes]


def _check(kind: str, band_p: torch.Tensor, frame: torch.Tensor, frame_shape,
           band_dtype=torch.bfloat16, frame_dtype=torch.bfloat16) -> None:
    bp = band_p.shape[2]
    if band_p.dtype != band_dtype or not band_p.is_contiguous() or bp % BLOCK_MULTIPLE:
        raise ValueError(f"{kind}: the padded band must be contiguous {band_dtype} [NB, D, b', b'] "
                         f"with b' a multiple of {BLOCK_MULTIPLE}, got {band_p.dtype} "
                         f"{tuple(band_p.shape)}")
    if (frame.dtype != frame_dtype or not frame.is_contiguous()
            or tuple(frame.shape) != tuple(frame_shape) or frame.device != band_p.device):
        raise ValueError(f"{kind}: the frame must be contiguous {frame_dtype} {list(frame_shape)} on "
                         f"{band_p.device}, got {frame.dtype} {tuple(frame.shape)}")


def launch_rowmajor(kind: str, band_p: torch.Tensor, frame: torch.Tensor, num_nodes: int, W: int,
                    block: int, F: int, scales: torch.Tensor | None = None,
                    wrow_bf16: bool | None = None) -> torch.Tensor:
    """Role A on CUDA operands from :func:`rowmajor_operands` (a bfloat16
    band, or a float32 band and its three frames), or on the padded int8
    band with its ``scales [NB, 2W+1]`` and :func:`rowmajor_frame`: K3's
    entry point, or B2c's where ``wrow_bf16`` is given.  Returns
    ``[num_nodes, F]`` float32."""
    nb, bp, Fp = band_p.shape[0], band_p.shape[2], frame.shape[-1]
    out = torch.empty((num_nodes, F), dtype=torch.float32, device=frame.device)
    shape, tail = (nb + 2 * W, bp, Fp), (nb, W, block, bp, F, Fp, num_nodes)
    if band_p.dtype == torch.float32:
        _check(kind, band_p, frame, (3, *shape), torch.float32)
        _launch(kind, "cgt_banded_spmm_direct_f32", band_p.data_ptr(), frame.data_ptr(),
                out.data_ptr(), *tail, _stream(frame.device))
    elif scales is None:
        _check(kind, band_p, frame, shape)
        _launch(kind, "cgt_banded_spmm_direct_bf16", band_p.data_ptr(), frame.data_ptr(),
                out.data_ptr(), *tail, _stream(frame.device))
    else:
        _check(kind, band_p, frame, shape, torch.int8)
        ptrs = band_p.data_ptr(), scales.data_ptr(), frame.data_ptr(), out.data_ptr()
        if wrow_bf16 is None:
            _launch(kind, "cgt_banded_spmm_quant", *ptrs, *tail, _stream(frame.device))
        else:
            _launch(kind, "cgt_banded_spmm_quant_fused_dot", *ptrs, *tail, int(bool(wrow_bf16)),
                    _stream(frame.device))
    return out


def blocked_on_operands(band_p: torch.Tensor, scales: torch.Tensor, xb: torch.Tensor, W: int,
                        block: int) -> torch.Tensor:
    """K6's and B3d's function on its prepared operands (the padded int8 band
    and :func:`blocked_x_operand`'s float32 or bfloat16 frame ``[NB + 2W, F,
    b']``), in plain torch: ``[NB, F, block]`` float32."""
    nb, F = band_p.shape[0], xb.shape[1]
    out = fm_on_operands(band_p, scales, xb.permute(1, 0, 2).reshape(F, -1), W, block)
    return out.view(F, nb, block).permute(1, 0, 2)


#: role B's feature-major entry point on the bfloat16 frame, by band type
FM_BF16_FRAME_ENTRIES = {torch.bfloat16: "cgt_fm_bf16_band", torch.int8: "cgt_banded_spmm_quant_fm_bf16"}


def launch_fm(kind: str, band_p: torch.Tensor, scales: torch.Tensor, x_pad_p: torch.Tensor, W: int,
              block: int) -> torch.Tensor:
    """Role B on CUDA operands: the padded band of transposed tiles,
    bfloat16 (B3a's ``fm_bf16_band``) or int8 (B3c's ``fm_deep``), its
    scales, and the bfloat16 frame from :func:`fm_frame`; returns ``[F,
    NB·block]`` float32."""
    nb, bp, F = band_p.shape[0], band_p.shape[2], x_pad_p.shape[0]
    band_dtype = band_p.dtype if band_p.dtype in FM_BF16_FRAME_ENTRIES else torch.bfloat16
    _check(kind, band_p, x_pad_p, (F, (nb + 2 * W) * bp), band_dtype)
    out = torch.empty((F, nb * block), dtype=torch.float32, device=x_pad_p.device)
    _launch(kind, FM_BF16_FRAME_ENTRIES[band_dtype], band_p.data_ptr(), scales.data_ptr(),
            x_pad_p.data_ptr(), out.data_ptr(), nb, W, block, bp, F, nb * block, nb * block,
            _stream(x_pad_p.device))
    return out


def launch_dma_only(kind: str, band_p: torch.Tensor, x_pad_p: torch.Tensor, num_nodes: int, W: int,
                    block: int) -> torch.Tensor:
    """B3a dma-only's launch on CUDA operands: the padded int8 band of
    transposed tiles and the bfloat16 frame from :func:`fm_frame`, ``F ≤
    block`` features; every stage of role B over them is staged.  Returns
    ``[F, num_nodes]`` float32."""
    nb, bp, F = band_p.shape[0], band_p.shape[2], x_pad_p.shape[0]
    _check(kind, band_p, x_pad_p, (F, (nb + 2 * W) * bp), torch.int8)
    out = torch.empty((F, num_nodes), dtype=torch.float32, device=x_pad_p.device)
    _launch(kind, "cgt_fm_dma_only", band_p.data_ptr(), x_pad_p.data_ptr(), out.data_ptr(), nb, W, block,
            bp, F, num_nodes, num_nodes, _stream(x_pad_p.device))
    return out


def _check_int8_band(kind: str, band_p: torch.Tensor, x: torch.Tensor,
                     x_dtypes=(torch.float32,)) -> None:
    if band_p.dtype != torch.int8 or not band_p.is_contiguous() or band_p.shape[2] % BLOCK_MULTIPLE:
        raise ValueError(f"{kind}: the padded band must be contiguous int8 [NB, D, b', b'] with b' a "
                         f"multiple of {BLOCK_MULTIPLE}, got {band_p.dtype} {tuple(band_p.shape)}")
    if x.dtype not in x_dtypes or x.device != band_p.device:
        names = " or ".join(str(t).removeprefix("torch.") for t in x_dtypes)
        raise ValueError(f"{kind}: x must be {names} on {band_p.device}, got {x.dtype} on {x.device}")


def launch_fm_int8(kind: str, band_p: torch.Tensor, scales: torch.Tensor, x: torch.Tensor,
                   x_block: int, x_cols: int, num_nodes: int, W: int, block: int) -> torch.Tensor:
    """Role B over the padded int8 band of transposed tiles and its scales,
    on float32 activations from :func:`fm_x_operand`: K4's launch (and its
    backward's over the transposed band).  Returns ``[F, num_nodes]``
    float32."""
    _check_int8_band(kind, band_p, x)
    nb, bp, F = band_p.shape[0], band_p.shape[2], x.shape[0]
    if x.dim() != 2 or x.stride(1) != 1 or x.shape[1] < x_cols:
        raise ValueError(f"{kind}: x must be [F, ≥{x_cols}] with unit inner stride, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    out = torch.empty((F, num_nodes), dtype=torch.float32, device=x.device)
    _launch(kind, "cgt_banded_spmm_quant_fm", band_p.data_ptr(), scales.data_ptr(), x.data_ptr(),
            out.data_ptr(), nb, W, block, bp, F, num_nodes, x_block, x_cols, x.stride(0),
            _stream(x.device))
    return out


#: role B's blocked entry point over the int8 band, by frame type
BLOCKED_ENTRIES = {torch.float32: "cgt_banded_spmm_quant_blocked",
                   torch.bfloat16: "cgt_banded_spmm_quant_blocked_bf16"}


def launch_blocked(kind: str, band_p: torch.Tensor, scales: torch.Tensor, xb: torch.Tensor, W: int,
                   block: int) -> torch.Tensor:
    """Role B over the padded int8 band of transposed tiles and its scales,
    on :func:`blocked_x_operand`'s frame ``[NB + 2W, F, b']``: K6's launch on
    a float32 frame, B3d's on a bfloat16 one.  Returns ``[NB, F, block]``
    float32."""
    _check_int8_band(kind, band_p, xb, tuple(BLOCKED_ENTRIES))
    nb, bp, F = band_p.shape[0], band_p.shape[2], xb.shape[1]
    if tuple(xb.shape) != (nb + 2 * W, F, bp) or not xb.is_contiguous():
        raise ValueError(f"{kind}: the frame must be contiguous [{nb + 2 * W}, F, {bp}], got "
                         f"{tuple(xb.shape)}")
    out = torch.empty((nb, F, block), dtype=torch.float32, device=xb.device)
    _launch(kind, BLOCKED_ENTRIES[xb.dtype], band_p.data_ptr(), scales.data_ptr(), xb.data_ptr(),
            out.data_ptr(), nb, W, block, bp, F, _stream(xb.device))
    return out


def w8a8_on_operands(band_p: torch.Tensor, scales: torch.Tensor, xq_p: torch.Tensor,
                     xscales: torch.Tensor, W: int, block: int) -> torch.Tensor:
    """K5's function on its prepared operands (the padded int8 band of
    transposed tiles, :func:`fm_frame`'s int8 frame ``[F, (NB + 2W)·b']``
    and the block scales ``[NB + 2W]``), in plain torch: ``[F, NB·block]``
    float32.  Each tile's dot is exact (summed in float64, as the kernel's
    in int32), then exact in float32 (``|dot| ≤ 127²·b < 2²⁴``), times
    ``fl(scale · xscale)`` and added in the order of the diagonals, each
    rounding apart, as the kernel rounds: the plain version bit for bit."""
    nb, bp, F = band_p.shape[0], band_p.shape[2], xq_p.shape[0]
    xw = xq_p.view(F, nb + 2 * W, bp).permute(1, 0, 2).to(torch.float64)
    out = torch.zeros((nb, F, bp), dtype=torch.float32, device=xq_p.device)
    for d in range(2 * W + 1):
        dots = torch.bmm(xw[d : d + nb], band_p[:, d].to(torch.float64)).to(torch.float32)
        out += (scales[:, d] * xscales[d : d + nb])[:, None, None] * dots
    return out[:, :, :block].permute(1, 0, 2).reshape(F, nb * block)


def launch_w8a8(kind: str, band_p: torch.Tensor, scales: torch.Tensor, xq_p: torch.Tensor,
                xscales: torch.Tensor, num_nodes: int, W: int, block: int) -> torch.Tensor:
    """K5's launch on CUDA operands: the padded int8 band of transposed
    tiles and its scales, the int8 frame from :func:`fm_frame` and its
    block scales ``[NB + 2W]``; returns ``[F, num_nodes]`` float32."""
    nb, bp, F = band_p.shape[0], band_p.shape[2], xq_p.shape[0]
    _check(kind, band_p, xq_p, (F, (nb + 2 * W) * bp), torch.int8, torch.int8)
    _check_xscales(kind, xscales, nb + 2 * W, xq_p.device)
    out = torch.empty((F, num_nodes), dtype=torch.float32, device=xq_p.device)
    _launch(kind, "cgt_banded_spmm_quant_fm_w8a8", band_p.data_ptr(), scales.data_ptr(), xq_p.data_ptr(),
            xscales.data_ptr(), out.data_ptr(), nb, W, block, bp, F, num_nodes, _stream(xq_p.device))
    return out


def w8a8_fm_frame(xq_blocks: torch.Tensor) -> torch.Tensor:
    """Node-major int8 blocks ``[NB + 2W, b, F]`` (B2b's activations,
    quantized per node block in the W-shifted padded frame) as K5's
    feature-major int8 frame ``[F, (NB + 2W)·b']``, each block padded to
    ``b'`` senders with zeros.  Four senders of one feature are packed into
    a 32-bit word (sender 4j + i in byte i, little-endian, as the frame's
    bytes lie), and the words are transposed: a transposing copy of a
    quarter as many elements as the bytes', whose cost goes by elements."""
    blocks, b, F = xq_blocks.shape
    bp = padded(b, BLOCK_MULTIPLE)
    if bp != b:
        xq_p = xq_blocks.new_zeros((blocks, bp, F))
        xq_p[:, :b] = xq_blocks
        xq_blocks = xq_p
    quads = xq_blocks.reshape(-1, 4, F)  # [(NB + 2W)·b' / 4, 4 senders, F]
    low = quads.view(torch.uint8)
    # byte 3 signed in the top byte, bytes 0-2 unsigned below it: disjoint
    # bit fields, so the sums are the word's bits and never overflow
    words = quads[:, 3].to(torch.int32) * (1 << 24)
    for i in range(3):
        words.add_(low[:, i].to(torch.int32), alpha=1 << (8 * i))
    return words.t().contiguous().view(torch.int8).view(F, blocks * bp)


def rowmajor_w8a8_on_operands(band_p: torch.Tensor, scales: torch.Tensor, xq_p: torch.Tensor,
                              xscales: torch.Tensor, num_nodes: int, W: int, block: int) -> torch.Tensor:
    """B2b's function on its prepared operands (the padded int8 band of
    receiver-major tiles, :func:`w8a8_fm_frame`'s int8 frame ``[F, (NB +
    2W)·b']`` and the block scales ``[NB + 2W]``), in plain torch:
    ``[num_nodes, F]`` float32, node-major.  Each tile's dot is exact
    (summed in float64, as the kernel's in int32), then exact in float32,
    times ``fl(scale · xscale)`` and added in the order of the diagonals,
    each rounding apart, as the kernel rounds: the plain version bit for
    bit."""
    nb, bp, F = band_p.shape[0], band_p.shape[2], xq_p.shape[0]
    xw = xq_p.view(F, nb + 2 * W, bp).permute(1, 2, 0).to(torch.float64)
    out = torch.zeros((nb, bp, F), dtype=torch.float32, device=xq_p.device)
    for d in range(2 * W + 1):
        dots = torch.bmm(band_p[:, d].to(torch.float64), xw[d : d + nb]).to(torch.float32)
        out += (scales[:, d] * xscales[d : d + nb])[:, None, None] * dots
    return out[:, :block].reshape(nb * block, F)[:num_nodes]


def _check_xscales(kind: str, xscales: torch.Tensor, blocks: int, device) -> None:
    if (xscales.dtype != torch.float32 or tuple(xscales.shape) != (blocks,)
            or not xscales.is_contiguous() or xscales.device != device):
        raise ValueError(f"{kind}: xscales must be contiguous float32 [{blocks}] on {device}")


def launch_rowmajor_w8a8(kind: str, band_p: torch.Tensor, scales: torch.Tensor, xq_p: torch.Tensor,
                         xscales: torch.Tensor, num_nodes: int, W: int, block: int) -> torch.Tensor:
    """B2b's launch on CUDA operands: the padded int8 band of receiver-major
    tiles and its scales, the int8 frame from :func:`w8a8_fm_frame` and its
    block scales ``[NB + 2W]``; returns ``[num_nodes, F]`` float32."""
    nb, bp, F = band_p.shape[0], band_p.shape[2], xq_p.shape[0]
    _check(kind, band_p, xq_p, (F, (nb + 2 * W) * bp), torch.int8, torch.int8)
    _check_xscales(kind, xscales, nb + 2 * W, xq_p.device)
    out = torch.empty((num_nodes, F), dtype=torch.float32, device=xq_p.device)
    _launch(kind, "cgt_banded_spmm_w8a8_rowmajor", band_p.data_ptr(), scales.data_ptr(), xq_p.data_ptr(),
            xscales.data_ptr(), out.data_ptr(), nb, W, block, bp, F, num_nodes, _stream(xq_p.device))
    return out


def launch_panel(kind: str, panel_p: torch.Tensor, scales: torch.Tensor, x_win_p: torch.Tensor,
                 num_blocks: int, W: int, block: int, R: int) -> torch.Tensor:
    """B3b's launch on CUDA operands: the padded panel (band rows 0..R-1,
    int8 transposed tiles), the scales of all ``num_blocks`` row blocks and
    the bfloat16 window ``[F, (R + 2W)·b']`` from :func:`fm_frame`; returns
    chunk i*'s panel ``[F, R·block]`` float32.  Every other chunk's sums go
    to a one-float sink, which is dropped."""
    bp, F = panel_p.shape[2], x_win_p.shape[0]
    _check(kind, panel_p, x_win_p, (F, (R + 2 * W) * bp), torch.int8)
    if panel_p.shape[0] != R or tuple(scales.shape) != (num_blocks, 2 * W + 1):
        raise ValueError(f"{kind}: the panel must be [{R}, D, b', b'] and the scales "
                         f"[{num_blocks}, {2 * W + 1}], got {tuple(panel_p.shape)} and {tuple(scales.shape)}")
    out = torch.empty((F, R * block), dtype=torch.float32, device=x_win_p.device)
    sink = torch.zeros(1, dtype=torch.float32, device=x_win_p.device)
    _launch(kind, "cgt_fm_compute_only", panel_p.data_ptr(), scales.data_ptr(), x_win_p.data_ptr(),
            out.data_ptr(), sink.data_ptr(), num_blocks, W, block, bp, F, R, _stream(x_win_p.device))
    return out
