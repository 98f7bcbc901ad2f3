"""Feature-major band-pipeline probes B3a-B3d: the kernels of
``benchmarks/fm_kernel_diag.py`` as library functions.

That script split the feature-major int8 band kernel (K4) into its parts.
Its kernel functions are ported here; the script itself (``main``, its
sweeps and its JSON) is not.  Each function takes the same operands as the
JAX one and returns the same array:

======  ==========================  =================================================
B3a     :func:`fm_dma_only`         the staging probe: ``x_pad[f, j] + tileT[j // b,
                                    0][f, j % b]`` (the W-shifted padded frame, not
                                    shifted back), ``[F, num_nodes]``
B3a     :func:`fm_bf16_band`        K4's function over a bfloat16 band of transposed
                                    tiles with per-dot scales
B3a     :func:`fm_w8a8`             K5's function on given int8 operands (it does not
                                    quantize)
B3b     :func:`fm_compute_only`     every chunk's dots against panel 0 with
                                    loop-variant indices; returns chunk i*'s panel
                                    ``[F, R·block]``
B3c     :func:`fm_deep`             K4's function (the TPU kernel's S-deep ring with the
                                    band copy split into K groups)
B3d     :func:`fm_blocked`          K4's function on blocked bfloat16 ``xb [NB + 2W, F,
                                    block]``, returning ``[NB, F, block]``
======  ==========================  =================================================

with ``pad_xT`` (the script's ``_pad_xT``) and ``quantize_xT_blocks``,
bitwise equal to JAX's.  ``fm_compute_only``'s chunk ``i*`` is the largest
even ``i < NB // R``: the TPU kernel's output slots alternate and its final
copy reads slot 0.  Its value is ``out[:, r·b:(r+1)·b] = Σ_d scales[i*·R +
r, d] · x_pad[:, kk·b:(kk+1)·b] @ tileT[rr, d]`` with ``rr = (r + i*) mod
R`` and ``kk = (r + d + i*) mod (R + 2W)``; only panel 0 of the band and of
x is read.

``rows_per_step`` (R) is part of the function for ``fm_dma_only`` and
``fm_compute_only`` (the output's shape and i*).  ``fm_dma_only``,
``fm_bf16_band``, ``fm_w8a8`` and ``fm_compute_only`` take ``NB // R``
chunks, and where ``R`` does not divide ``NB`` the TPU kernels leave the
output's tail unwritten: here that raises ``ValueError``.  ``fm_deep`` and
``fm_blocked`` reduce R to a divisor of NB as JAX does; their result does
not depend on R, the depth S or the band splits K.  Where JAX asserts
(``R % K``), ``ValueError`` is raised; so it is for a depth outside
:data:`DEPTHS`, a split outside :data:`BAND_SPLITS` and, for
``fm_dma_only``, ``F > block``.

All six run on the tensor-core body ``csrc/band_mma.cu`` (``wgmma`` on
tiles staged by TMA into an ``mbarrier`` ring).  ``fm_w8a8`` is K5's
function bit for bit on its given int8 operands, so it is K5's launch on
them (``s8 × s8`` products, exact in int32).  ``fm_bf16_band``,
``fm_compute_only``, ``fm_deep`` and ``fm_blocked`` are role B:
``fm_bf16_band`` over its bfloat16 band, the others over the int8 band,
which the kernel widens to bfloat16 in shared memory.  ``fm_dma_only`` is
role B's producer and ring over the int8 band and the bfloat16 frame with
no work in its stages (no widening, no ``wgmma``): every stage B3d stages
is staged, and its consumers add ``x`` and diagonal 0's tile rows from two
stages of each unit, one float32 add, bit for bit its plain version.  ``fm_compute_only``
walks every chunk's units over panel 0 with the loop-variant indices, the
panel under L2 evict_last, on the bfloat16 window; chunk i*'s units store
and the others fold into a one-float sink, so no chunk's arithmetic can be
dropped.  ``fm_blocked`` reads its caller's bfloat16 blocked frame.
``fm_deep`` is K4's launch on the caller's float32 ``xT``, which the kernel
rounds to bfloat16 in registers as ``pad_xT`` casts it: the same function
bit for bit as role B's launch on ``pad_xT``'s bfloat16 frame, without the
pad pass, and faster on the H100 than that pass and launch together
(``chip_smoke.py`` phase 22 times both).  That body takes any block: the
wrappers pad the band and the frame (``fm_w8a8``'s int8 frame too) to a
multiple of 16 with zeros where it is not one (:mod:`band_mma`).
``fm_dma_only`` takes any block with ``F ≤ block``.  Its
schedule is its own, so ``rows_per_step``, ``depth`` and ``band_splits``
are checked as the TPU kernels take them and shape nothing.
Beside each kernel sit its plain PyTorch version (``*_reference``, the
oracle of the tests and of ``chip_smoke.py``) and a launch counter
(``*_kernel.launches``).  The entry points take the plain version for CPU
tensors only; for a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import torch

from connectome_gnn_tpu_torch.ops import band_mma
from connectome_gnn_tpu_torch.ops.banded_quant import (
    MAX_EXACT_W8A8_BLOCK,
    QuantizedBandedMatrixFM,
    _check_band,
    _check_blocked,
    _fm_output,
    _fm_windows,
    _pad_fm,
    _windows_times_band,
    banded_spmm_quant_fm_reference,
    launch_fm_int8_on_xT,
    quantize_activations_fm,
    w8a8_windows_times_band,
)

#: the pipeline depths (S) ``fm_deep`` and ``fm_blocked`` take: those the script sweeps
DEPTHS = (2, 3, 4, 6, 8)
#: the band splits (K) ``fm_deep`` takes
BAND_SPLITS = (1, 2, 4)

#: ``[F, NBwin·block]`` → int8 and one float32 scale per column block (max-abs
#: / 127; all-zero blocks get scale 1): K5's activation quantizer, which is
#: the script's ``quantize_xT_blocks``
quantize_xT_blocks = quantize_activations_fm


def pad_xT(xT: torch.Tensor, num_nodes: int, num_blocks: int, bandwidth: int, block: int,
           dtype=torch.bfloat16) -> torch.Tensor:
    """``xT[:, :num_nodes]`` cast to ``dtype`` in the W-shifted padded frame
    ``[F, (NB + 2W)·block]``, bitwise equal to the script's ``_pad_xT``."""
    return _pad_fm(xT[:, :num_nodes], num_blocks, bandwidth, block, dtype)


# ---------------------------------------------------------------------------
# Geometry: R, S and K as the TPU kernels take them
# ---------------------------------------------------------------------------


def _whole_chunks(kind: str, nb: int, rows_per_step: int) -> int:
    """``R`` for the kernels that run ``NB // R`` chunks as given."""
    R = int(rows_per_step)
    if R < 1 or nb % R:
        raise ValueError(f"{kind}: {nb} row blocks are not whole chunks of rows_per_step={R} "
                         "(the TPU kernel leaves the output's tail unwritten)")
    return R


def _check_depth(kind: str, depth: int) -> None:
    if depth not in DEPTHS:
        raise ValueError(f"{kind}: depth {depth} is not one of {DEPTHS}")


def _divisor_rows(kind: str, nb: int, rows_per_step: int, depth: int) -> int:
    """``R`` reduced to a divisor of ``NB`` (``fm_kernel_diag.py:318-320``)."""
    _check_depth(kind, depth)
    R = max(1, min(int(rows_per_step), nb))
    while nb % R:
        R -= 1
    return R


def _deep_rows(kind: str, nb: int, rows_per_step: int, depth: int, band_splits: int) -> int:
    R = _divisor_rows(kind, nb, rows_per_step, depth)
    if band_splits < 1 or R % band_splits:
        raise ValueError(f"{kind}: band_splits={band_splits} does not divide the {R} rows of a chunk")
    if band_splits not in BAND_SPLITS:
        raise ValueError(f"{kind}: band_splits={band_splits} is not one of {BAND_SPLITS}")
    return R


def _dma_only_rows(kind: str, q: QuantizedBandedMatrixFM, F: int, rows_per_step: int) -> int:
    if F > q.block:
        raise ValueError(f"{kind}: F={F} exceeds the block {q.block} (it adds tile rows 0..F-1)")
    return _whole_chunks(kind, q.num_blocks, rows_per_step)


def _bf16_fm(kind: str, band_bf16T: torch.Tensor, scales: torch.Tensor, num_nodes: int,
             W: int) -> QuantizedBandedMatrixFM:
    if band_bf16T.dtype != torch.bfloat16:
        raise ValueError(f"{kind}: the band must be bfloat16, got {band_bf16T.dtype}")
    return QuantizedBandedMatrixFM(band_bf16T, scales, int(num_nodes), int(W))


def _window0(q: QuantizedBandedMatrixFM, xT: torch.Tensor, R: int) -> torch.Tensor:
    """Window 0 of the bfloat16 padded frame, ``[F, (R + 2W)·block]``: all
    that ``fm_compute_only`` reads of x."""
    W, b = q.bandwidth, q.block
    return _pad_fm(xT[:, : min(q.num_nodes, (R + W) * b)], R, W, b, torch.bfloat16)


def _check_w8a8_block(q: QuantizedBandedMatrixFM) -> None:
    if q.block > MAX_EXACT_W8A8_BLOCK:
        raise ValueError(
            f"block {q.block} > {MAX_EXACT_W8A8_BLOCK}: the float32 int8 dot is no longer exact"
        )


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the oracle; TF32 must be off on the card)
# ---------------------------------------------------------------------------


def fm_dma_only_reference(q: QuantizedBandedMatrixFM, xT: torch.Tensor,
                          rows_per_step: int = 32) -> torch.Tensor:
    """B3a's copy-plus-add in plain torch: ``[F, num_nodes]`` float32."""
    F, nb, b = xT.shape[0], q.num_blocks, q.block
    _dma_only_rows("B3a fm_dma_only", q, F, rows_per_step)
    x_pad = pad_xT(xT, q.num_nodes, nb, q.bandwidth, b)[:, : nb * b].to(torch.float32)
    tile_rows = q.band_qT[:, 0, :F, :].to(torch.float32).transpose(0, 1).reshape(F, nb * b)
    return (x_pad + tile_rows)[:, : q.num_nodes]


def fm_compute_only_reference(q: QuantizedBandedMatrixFM, xT: torch.Tensor,
                              rows_per_step: int = 32) -> torch.Tensor:
    """B3b's value in plain torch: chunk i*'s panel, ``[F, R·block]``
    float32 (only chunk i* is computed: the others feed no output).  One
    batched product over the chunk's ``R × D`` tiles, so on the card its
    time is the device's, not the host's issue rate."""
    nb, W, b = q.num_blocks, q.bandwidth, q.block
    R = _whole_chunks("B3b fm_compute_only", nb, rows_per_step)
    D, win, i_star = 2 * W + 1, R + 2 * W, (nb // R - 1) // 2 * 2
    F = xT.shape[0]
    x_blocks = _window0(q, xT, R).to(torch.float32).reshape(F, win, b)
    r = torch.arange(R, device=q.band_qT.device)
    kk = (r[:, None] + torch.arange(D, device=r.device) + i_star) % win  # [R, D]
    tiles = q.band_qT[(r + i_star) % R].to(torch.float32)  # [R, D, b, b]
    dots = x_blocks[:, kk].permute(1, 2, 0, 3) @ tiles  # [R, D, F, b]
    scales = q.scales[i_star * R : (i_star + 1) * R, :, None, None]
    return (scales * dots).sum(1).permute(1, 0, 2).reshape(F, R * b)


def fm_bf16_band_reference(band_bf16T: torch.Tensor, scales: torch.Tensor, num_nodes: int, W: int,
                           xT: torch.Tensor, rows_per_step: int = 32) -> torch.Tensor:
    """B3a's bfloat16-band dots in plain torch: ``[F, num_nodes]`` float32."""
    q = _bf16_fm("B3a fm_bf16_band", band_bf16T, scales, num_nodes, W)
    nb, b = q.num_blocks, q.block
    _whole_chunks("B3a fm_bf16_band", nb, rows_per_step)
    xw = _fm_windows(pad_xT(xT, q.num_nodes, nb, q.bandwidth, b), nb, q.bandwidth, b)
    return _fm_output(_windows_times_band(q, xw), q.num_nodes)


def fm_w8a8_reference(q: QuantizedBandedMatrixFM, xqT_pad: torch.Tensor, xscales: torch.Tensor,
                      rows_per_step: int = 32) -> torch.Tensor:
    """B3a's int8 × int8 dots in plain torch on the given operands (K5's
    arithmetic): ``[F, num_nodes]`` float32.  The int8 dots run as float32
    products, exact while ``127² · block < 2^24``; larger blocks raise."""
    _whole_chunks("B3a fm_w8a8", q.num_blocks, rows_per_step)
    _check_w8a8_block(q)
    return w8a8_windows_times_band(q, xqT_pad, xscales)


def fm_deep_reference(q: QuantizedBandedMatrixFM, xT: torch.Tensor, rows_per_step: int = 32,
                      depth: int = 4, band_splits: int = 1) -> torch.Tensor:
    """B3c in plain torch: K4's function, ``[F, num_nodes]`` float32."""
    _deep_rows("B3c fm_deep", q.num_blocks, rows_per_step, depth, band_splits)
    return banded_spmm_quant_fm_reference(q, xT)


def fm_blocked_reference(q: QuantizedBandedMatrixFM, xb: torch.Tensor, rows_per_step: int = 32,
                         depth: int = 2) -> torch.Tensor:
    """B3d in plain torch: K4's function on blocked ``xb [NB + 2W, F,
    block]`` rounded to bfloat16, ``[NB, F, block]`` float32."""
    kind = "B3d fm_blocked"
    _divisor_rows(kind, q.num_blocks, rows_per_step, depth)
    _check_blocked(kind, q, xb)
    return _windows_times_band(q, xb.to(torch.bfloat16).to(torch.float32))


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


def _check_xT(kind: str, xT: torch.Tensor, num_nodes: int) -> None:
    if xT.dim() != 2 or xT.shape[1] < num_nodes:
        raise ValueError(f"{kind}: activations {tuple(xT.shape)} are not [F, ≥{num_nodes}]")


def _check_operand(kind: str, x: torch.Tensor, dtype, shape) -> None:
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{kind}: operand must be contiguous {dtype} {list(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)} strides {x.stride()}")


def _launch_bf16_band(q: QuantizedBandedMatrixFM, x_pad: torch.Tensor) -> torch.Tensor:
    """B3a's bfloat16-band dots on the padded frame, on the tensor-core
    body (band and frame padded to a block that is a multiple of 16 where
    they are not); ``[F, NB·block]``.  Counted as a launch of
    :func:`fm_bf16_band_kernel`."""
    kind, nb, W, b = "B3a fm_bf16_band", q.num_blocks, q.bandwidth, q.block
    _check_band(kind, q.band_qT, q.scales, x_pad.device, (torch.bfloat16,))
    F = x_pad.shape[0]
    _check_operand(kind, x_pad, torch.bfloat16, (F, (nb + 2 * W) * b))
    if F == 0:
        return torch.empty((F, nb * b), dtype=torch.float32, device=x_pad.device)
    with torch.cuda.device(x_pad.device):
        out = band_mma.launch_fm(kind, band_mma.pad_band(q.band_qT), q.scales,
                                 band_mma.fm_frame(x_pad, nb, W, b), W, b)
    fm_bf16_band_kernel.launches += 1
    return out


def _launch_dma_only(q: QuantizedBandedMatrixFM, x_pad: torch.Tensor) -> torch.Tensor:
    """B3a's copy-plus-add on the padded frame, on role B's ring (the band
    and the frame padded to a block that is a multiple of 16 where they are
    not); ``[F, num_nodes]``.  Counted as a launch of
    :func:`fm_dma_only_kernel`."""
    kind, nb, W, b, n = "B3a fm_dma_only", q.num_blocks, q.bandwidth, q.block, q.num_nodes
    _check_band(kind, q.band_qT, None, x_pad.device)
    F = x_pad.shape[0]
    _check_operand(kind, x_pad, torch.bfloat16, (F, (nb + 2 * W) * b))
    if F == 0 or n == 0:
        return torch.empty((F, n), dtype=torch.float32, device=x_pad.device)
    with torch.cuda.device(x_pad.device):
        out = band_mma.launch_dma_only(kind, band_mma.pad_band(q.band_qT), band_mma.fm_frame(x_pad, nb, W, b),
                                       n, W, b)
    fm_dma_only_kernel.launches += 1
    return out


def _launch_compute_only(q: QuantizedBandedMatrixFM, x_win: torch.Tensor, R: int) -> torch.Tensor:
    """B3b on window 0 ``x_win [F, (R + 2W)·block]``, role B over panel 0
    (band rows 0..R-1; the panel and the window padded to a block that is a
    multiple of 16 where it is not one); ``[F, R·block]``.  Counted as a
    launch of :func:`fm_compute_only_kernel`."""
    kind, nb, W, b = "B3b fm_compute_only", q.num_blocks, q.bandwidth, q.block
    _check_band(kind, q.band_qT, q.scales, x_win.device)
    F = x_win.shape[0]
    _check_operand(kind, x_win, torch.bfloat16, (F, (R + 2 * W) * b))
    if F == 0:
        return torch.empty((F, R * b), dtype=torch.float32, device=x_win.device)
    with torch.cuda.device(x_win.device):
        out = band_mma.launch_panel(kind, band_mma.pad_band(q.band_qT[:R]), q.scales,
                                    band_mma.fm_frame(x_win, R, W, b), nb, W, b, R)
    fm_compute_only_kernel.launches += 1
    return out


def fm_dma_only_kernel(q: QuantizedBandedMatrixFM, xT: torch.Tensor,
                       rows_per_step: int = 32) -> torch.Tensor:
    """Pad ``xT`` to the bfloat16 frame in torch, then launch B3a's
    copy-plus-add on CUDA tensors; returns ``[F, num_nodes]`` float32.
    ``rows_per_step`` is checked as the TPU kernel takes it and shapes
    nothing."""
    kind = "B3a fm_dma_only"
    _dma_only_rows(kind, q, xT.shape[0], rows_per_step)
    _check_xT(kind, xT, q.num_nodes)
    x_pad = pad_xT(xT, q.num_nodes, q.num_blocks, q.bandwidth, q.block)
    return _launch_dma_only(q, x_pad)


def fm_compute_only_kernel(q: QuantizedBandedMatrixFM, xT: torch.Tensor,
                           rows_per_step: int = 32) -> torch.Tensor:
    """Pad window 0 of ``xT`` in torch, then launch B3b on CUDA tensors;
    returns chunk i*'s panel ``[F, R·block]`` float32."""
    kind = "B3b fm_compute_only"
    R = _whole_chunks(kind, q.num_blocks, rows_per_step)
    _check_xT(kind, xT, q.num_nodes)
    return _launch_compute_only(q, _window0(q, xT, R), R)


def fm_bf16_band_kernel(band_bf16T: torch.Tensor, scales: torch.Tensor, num_nodes: int, W: int,
                        xT: torch.Tensor, rows_per_step: int = 32) -> torch.Tensor:
    """Pad ``xT`` in torch, then launch B3a's bfloat16-band dots on CUDA
    tensors; returns ``[F, num_nodes]`` float32."""
    kind = "B3a fm_bf16_band"
    q = _bf16_fm(kind, band_bf16T, scales, num_nodes, W)
    _whole_chunks(kind, q.num_blocks, rows_per_step)
    _check_xT(kind, xT, q.num_nodes)
    x_pad = pad_xT(xT, q.num_nodes, q.num_blocks, q.bandwidth, q.block)
    return _launch_bf16_band(q, x_pad)[:, : q.num_nodes]


def fm_w8a8_kernel(q: QuantizedBandedMatrixFM, xqT_pad: torch.Tensor, xscales: torch.Tensor,
                   rows_per_step: int = 32) -> torch.Tensor:
    """Launch B3a's int8 × int8 dots on CUDA tensors, K5's launch on the
    given operands: ``xqT_pad [F, (NB + 2W)·block]`` int8 and ``xscales
    [NB + 2W]`` float32 (the band and the frame padded to a block that is a
    multiple of 16 where it is not one); returns ``[F, num_nodes]``
    float32.  ``rows_per_step`` is checked as the TPU kernel takes it and
    shapes nothing."""
    kind, nb, W, b, n = "B3a fm_w8a8", q.num_blocks, q.bandwidth, q.block, q.num_nodes
    _whole_chunks(kind, nb, rows_per_step)
    _check_band(kind, q.band_qT, q.scales, xqT_pad.device)
    F = xqT_pad.shape[0]
    _check_operand(kind, xqT_pad, torch.int8, (F, (nb + 2 * W) * b))
    _check_operand(kind, xscales, torch.float32, (nb + 2 * W,))
    if xscales.device != xqT_pad.device:
        raise ValueError(f"{kind}: xscales must be on {xqT_pad.device}")
    if F == 0 or n == 0:
        return torch.empty((F, n), dtype=torch.float32, device=xqT_pad.device)
    with torch.cuda.device(xqT_pad.device):
        out = band_mma.launch_w8a8(kind, band_mma.pad_band(q.band_qT), q.scales,
                                   band_mma.fm_frame(xqT_pad, nb, W, b), xscales, n, W, b)
    fm_w8a8_kernel.launches += 1
    return out


def fm_deep_kernel(q: QuantizedBandedMatrixFM, xT: torch.Tensor, rows_per_step: int = 32,
                   depth: int = 4, band_splits: int = 1) -> torch.Tensor:
    """Launch B3c on CUDA tensors, K4's launch on float32 ``xT [F,
    ≥num_nodes]`` as it is; returns ``[F, num_nodes]`` float32.
    ``rows_per_step``, ``depth`` and ``band_splits`` are checked and change
    nothing."""
    kind = "B3c fm_deep"
    _deep_rows(kind, q.num_blocks, rows_per_step, depth, band_splits)
    _check_xT(kind, xT, q.num_nodes)
    return launch_fm_int8_on_xT(kind, fm_deep_kernel, q, xT)


def fm_blocked_kernel(q: QuantizedBandedMatrixFM, xb: torch.Tensor, rows_per_step: int = 32,
                      depth: int = 2) -> torch.Tensor:
    """Launch B3d, role B over the int8 band, on CUDA tensors: contiguous
    bfloat16 ``xb [NB + 2W, F, block]``, read as it is (copied, padded, only
    where the block is not a multiple of 16 or its base not 16-byte
    aligned); returns ``[NB, F, block]`` float32.  ``rows_per_step`` and
    ``depth`` are checked and change nothing."""
    kind, nb, W, b = "B3d fm_blocked", q.num_blocks, q.bandwidth, q.block
    _divisor_rows(kind, nb, rows_per_step, depth)
    _check_band(kind, q.band_qT, q.scales, xb.device)
    _check_blocked(kind, q, xb)
    F = xb.shape[1]
    _check_operand(kind, xb, torch.bfloat16, (nb + 2 * W, F, b))
    if F == 0:
        return torch.empty((nb, F, b), dtype=torch.float32, device=xb.device)
    with torch.cuda.device(xb.device):
        out = band_mma.launch_blocked(kind, band_mma.pad_band(q.band_qT), q.scales,
                                      band_mma.blocked_x_operand(xb, b), W, b)
    fm_blocked_kernel.launches += 1
    return out


fm_dma_only_kernel.launches = 0
fm_compute_only_kernel.launches = 0
fm_bf16_band_kernel.launches = 0
fm_w8a8_kernel.launches = 0
fm_deep_kernel.launches = 0
fm_blocked_kernel.launches = 0


# ---------------------------------------------------------------------------
# Entry points: the kernel on CUDA tensors, the plain version on CPU tensors
# ---------------------------------------------------------------------------


def fm_dma_only(q: QuantizedBandedMatrixFM, xT: torch.Tensor, rows_per_step: int = 32) -> torch.Tensor:
    """``x_pad[f, j] + tileT[j // b, 0][f, j % b]`` for ``j < num_nodes``:
    ``[F, num_nodes]`` float32, every tile of the band staged."""
    if xT.device.type == "cpu":
        return fm_dma_only_reference(q, xT, rows_per_step)
    return fm_dma_only_kernel(q, xT, rows_per_step)


def fm_compute_only(q: QuantizedBandedMatrixFM, xT: torch.Tensor,
                    rows_per_step: int = 32) -> torch.Tensor:
    """Every chunk's dots against panel 0; chunk i*'s panel ``[F, R·block]``."""
    if xT.device.type == "cpu":
        return fm_compute_only_reference(q, xT, rows_per_step)
    return fm_compute_only_kernel(q, xT, rows_per_step)


def fm_bf16_band(band_bf16T: torch.Tensor, scales: torch.Tensor, num_nodes: int, W: int,
                 xT: torch.Tensor, rows_per_step: int = 32) -> torch.Tensor:
    """``(A @ x)ᵀ`` over a bfloat16 band of transposed tiles ``[NB, 2W+1,
    block, block]`` with per-dot ``scales [NB, 2W+1]``, ``x`` rounded to
    bfloat16; ``[F, num_nodes]`` float32."""
    if xT.device.type == "cpu":
        return fm_bf16_band_reference(band_bf16T, scales, num_nodes, W, xT, rows_per_step)
    return fm_bf16_band_kernel(band_bf16T, scales, num_nodes, W, xT, rows_per_step)


def fm_w8a8(q: QuantizedBandedMatrixFM, xqT_pad: torch.Tensor, xscales: torch.Tensor,
            rows_per_step: int = 32) -> torch.Tensor:
    """``(A_q @ x_q)ᵀ`` on given int8 activations in the padded frame and
    their block scales (:func:`quantize_xT_blocks`); ``[F, num_nodes]``."""
    if xqT_pad.device.type == "cpu":
        return fm_w8a8_reference(q, xqT_pad, xscales, rows_per_step)
    return fm_w8a8_kernel(q, xqT_pad, xscales, rows_per_step)


def fm_deep(q: QuantizedBandedMatrixFM, xT: torch.Tensor, rows_per_step: int = 32, depth: int = 4,
            band_splits: int = 1) -> torch.Tensor:
    """``(A_q @ x)ᵀ`` (K4's function), ``x`` rounded to bfloat16; ``[F,
    num_nodes]`` float32."""
    if xT.device.type == "cpu":
        return fm_deep_reference(q, xT, rows_per_step, depth, band_splits)
    return fm_deep_kernel(q, xT, rows_per_step, depth, band_splits)


def fm_blocked(q: QuantizedBandedMatrixFM, xb: torch.Tensor, rows_per_step: int = 32,
               depth: int = 2) -> torch.Tensor:
    """``A_q @ x`` on blocked bfloat16 activations ``xb [NB + 2W, F, block]``
    in the padded frame; ``[NB, F, block]`` float32."""
    if xb.device.type == "cpu":
        return fm_blocked_reference(q, xb, rows_per_step, depth)
    return fm_blocked_kernel(q, xb, rows_per_step, depth)
