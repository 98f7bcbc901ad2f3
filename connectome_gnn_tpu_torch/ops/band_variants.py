"""Band SpMM variants: a bfloat16 band, int8 band by int8 activations, and
an int8 band with its scales folded into the tiles (B2a, B2b, B2c).

The port of the kernels in ``benchmarks/quant_kernel_diag.py:55-290``, as
library functions; that script, its timing phases and its records are not
ported.  Every variant computes ``out[rb] = Σ_d tile[rb, d] ·
x_blocks[rb + d - W]`` over a row-major band with receiver-major tiles
and returns ``[num_nodes, F]`` float32:

===  ========================================  ==========================================
B2a  :func:`banded_spmm_bf16`                  bfloat16 band, ``x`` rounded to bfloat16
                                               (K7's bfloat16 function, the same kernel)
B2b  :func:`banded_spmm_w8a8`                  int8 band by int8 ``x`` (one scale per node
                                               block, :func:`quantize_x_blocks`), exact
                                               int32 dots, ``(scale · xscale) · dot``
B2c  :func:`banded_spmm_quant_fused_dot`       int8 band, each tile widened as
                                               ``scale · float(int8)`` (rounded to
                                               bfloat16 with ``wrow_bf16``), ``x`` rounded
                                               to bfloat16, one float32 sum per row block
===  ========================================  ==========================================

B2c's tile is float32 unless ``wrow_bf16``: in the TPU kernel a float32
scalar times a bfloat16 array promotes to float32.  Its rounding differs
from K3's, which scales each diagonal's dot.

B2a, B2b and B2c are role A of the tensor-core body ``csrc/band_mma.cu``
(B2a is K7's bfloat16 launch; B2c has an entry point of its own over K3's
operands, the int8 band and ``x`` rounded to bfloat16 in the padded frame;
B2b one over the int8 band and int8 ``x``).
With ``wrow_bf16`` B2c's kernel folds each scale into its tile as it widens
the int8 entries, ``bf16(fl(scale · q))``, the plain version's two
roundings, so every product is exact and the kernel differs from the plain
version only in the order of its float32 sums.  Without it the float32
tile ``fl(scale · q)`` is no bfloat16 operand, so the kernel takes K3's
order: each tile's exact dot ``q @ x̂``, then ``scale · dot``.  That
differs from the plain fold by one float32 rounding of each product,
``fl(scale · q) · x̂`` against ``scale · q · x̂``, an error of the same size
as the order of the float32 sums.  The kernel holds 1e-5 of the fold
summed in float64 (``sum_dtype=torch.float64``) at the card tests' data;
there, with random signs and cancelling sums, the plain version's own
float32 sums differ from it by more.

B2b runs on K5's ``s8 × s8`` products (``wgmma`` m64n64k32, exact in
int32): its wrapper quantizes ``x`` per node block in torch, as the TPU
function quantizes outside its ``pallas_call``, and hands the kernel the
int8 values transposed to K5's feature-major frame (the 8-bit products
take no transposed operand), padded to a block that is a multiple of 16
where it is not one (:func:`w8a8_operands`).  Each tile's dot is exact,
then exact in float32 (``127²·b < 2²⁴`` for ``b ≤ 1040``), times
``fl(scale · xscale)`` and added, each rounding apart: the plain version
bit for bit.  Beside each sits its plain PyTorch version
(``*_reference``, the oracle of the tests and of ``chip_smoke.py``) and a
launch counter (``*_kernel.launches``).  The entry points take the plain
version for CPU tensors only; for a CUDA tensor they launch the kernel or
raise.  The TPU kernels' ``rows_per_step`` is gone: the result depends on
it only through the order of a float32 sum.

:func:`banded_spmm_quant_manual` is the row-major wrapper over K4 that the
script's checks phase holds beside the variants; it has no kernel of its
own.
"""

from __future__ import annotations

import torch

from connectome_gnn_tpu_torch.ops import band_mma
from connectome_gnn_tpu_torch.ops.banded import BandedMatrix, pad_blocks
from connectome_gnn_tpu_torch.ops.banded_direct import banded_spmm_direct_reference, launch_direct
from connectome_gnn_tpu_torch.ops.banded_quant import (
    MAX_EXACT_W8A8_BLOCK,
    QuantizedBandedMatrix,
    _check_activations,
    _check_band,
    _symmetric_int8,
    banded_spmm_quant_fm,
    to_feature_major,
)


def quantize_x_blocks(x_pad_blocks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-node-block symmetric int8 quantization of activations, bitwise
    equal to the JAX function: ``[NBP, block, F]`` float32 → int8 of the
    same shape and ``[NBP]`` float32 scales (max-abs over the block's
    nodes and features / 127; all-zero blocks get scale 1)."""
    maxabs = x_pad_blocks.abs().amax(dim=(1, 2))
    scales = torch.where(maxabs > 0, maxabs / 127.0, torch.ones_like(maxabs))
    return _symmetric_int8(x_pad_blocks, scales, (-1, 1, 1)), scales


def _bf16_band(kind: str, band_bf16: torch.Tensor, num_nodes: int, W: int) -> BandedMatrix:
    if band_bf16.dtype != torch.bfloat16:
        raise ValueError(f"{kind}: the band must be bfloat16, got {band_bf16.dtype}")
    return BandedMatrix(band_bf16, int(num_nodes), int(W))


def _w8a8_operands(q: QuantizedBandedMatrix, x: torch.Tensor):
    """``x[:num_nodes]`` in the W-shifted padded frame, ``[NB + 2W, block,
    F]``, quantized per block: ``(xq int8, xscales [NB + 2W])``; the halo
    blocks are zero and get scale 1."""
    nb, W, block, n = q.num_blocks, q.bandwidth, q.block, q.num_nodes
    return quantize_x_blocks(pad_blocks(x[:n].to(torch.float32), nb, W, block))


def w8a8_operands(q: QuantizedBandedMatrix, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """B2b's activation operands as its kernel reads them: ``x[:num_nodes]``
    quantized per node block in the W-shifted padded frame
    (:func:`quantize_x_blocks`, bitwise JAX's), its int8 values transposed
    to the feature-major frame ``[F, (NB + 2W)·b']`` (each block padded to
    ``b'`` senders with zeros), and the block scales ``[NB + 2W]``.  The
    quantization runs node-major, then the int8 values are transposed as
    32-bit words of four senders (:func:`~connectome_gnn_tpu_torch.ops.
    band_mma.w8a8_fm_frame`): on the H100 the cheapest of the builds
    ``chip_smoke.py`` phase 19 times."""
    xq, xscales = _w8a8_operands(q, x)
    return band_mma.w8a8_fm_frame(xq), xscales


def _check_x(kind: str, q: QuantizedBandedMatrix, x: torch.Tensor, dtype=None) -> None:
    """``x [≥num_nodes, F]``; of ``dtype`` and with unit inner stride where
    ``dtype`` is given."""
    if dtype is not None:
        _check_activations(kind, x, q.num_nodes, x.shape[-1], dtype)
    elif x.dim() != 2 or x.shape[0] < q.num_nodes:
        raise ValueError(f"{kind}: activations {tuple(x.shape)} are not [≥{q.num_nodes}, F]")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the oracle; TF32 must be off on the card)
# ---------------------------------------------------------------------------


def banded_spmm_bf16_reference(band_bf16: torch.Tensor, num_nodes: int, W: int,
                               x: torch.Tensor) -> torch.Tensor:
    """B2a's arithmetic in plain torch: K7's over a bfloat16 band."""
    return banded_spmm_direct_reference(_bf16_band("B2a banded_spmm_bf16", band_bf16, num_nodes, W), x)


def banded_spmm_w8a8_reference(q: QuantizedBandedMatrix, x: torch.Tensor) -> torch.Tensor:
    """B2b's arithmetic in plain torch: ``Σ_d (scale[rb, d] · xscale[rb +
    d]) · (tile @ xq_block)``, ``[num_nodes, F]`` float32.  The int8 dots
    run as float32 products of int8 values, exact while ``127² · block <
    2^24``; larger blocks raise ``ValueError``."""
    nb, W, block, n = q.num_blocks, q.bandwidth, q.block, q.num_nodes
    if block > MAX_EXACT_W8A8_BLOCK:
        raise ValueError(
            f"block {block} > {MAX_EXACT_W8A8_BLOCK}: the float32 int8 dot is no longer exact"
        )
    xq, xscales = _w8a8_operands(q, x)
    xw = xq.to(torch.float32)
    out = xw.new_zeros((nb, block, xw.shape[2]))
    for d in range(2 * W + 1):
        dots = torch.bmm(q.band_q[:, d].to(torch.float32), xw[d : d + nb])
        s = q.scales[:, d] * xscales[d : d + nb]
        out += s[:, None, None] * dots
    return out.reshape(nb * block, -1)[:n]


def banded_spmm_quant_fused_dot_reference(q: QuantizedBandedMatrix, x: torch.Tensor,
                                          wrow_bf16: bool = False,
                                          sum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """B2c's arithmetic in plain torch: tiles widened as ``scale ·
    float(int8)`` (rounded to bfloat16 with ``wrow_bf16``) times ``x``
    rounded to bfloat16, float32 sums; ``[num_nodes, F]`` float32.
    ``sum_dtype=torch.float64`` takes the products and sums of the same
    tiles and ``x`` in float64 and rounds the result to float32 once."""
    nb, W, block, n = q.num_blocks, q.bandwidth, q.block, q.num_nodes
    xb = pad_blocks(x[:n].to(torch.bfloat16).to(sum_dtype), nb, W, block)
    out = xb.new_zeros((nb, block, xb.shape[2]))
    for d in range(2 * W + 1):
        wrow = q.scales[:, d, None, None] * q.band_q[:, d].to(torch.float32)
        if wrow_bf16:
            wrow = wrow.to(torch.bfloat16)
        out += torch.bmm(wrow.to(sum_dtype), xb[d : d + nb])
    return out.reshape(nb * block, -1)[:n].to(torch.float32)


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


def banded_spmm_bf16_kernel(band_bf16: torch.Tensor, num_nodes: int, W: int,
                            x: torch.Tensor) -> torch.Tensor:
    """Launch B2a on CUDA tensors (K7's bfloat16 instantiation, counted
    here): ``x [≥num_nodes, F]`` float32; returns ``[num_nodes, F]``
    float32."""
    kind = "B2a banded_spmm_bf16"
    return launch_direct(kind, _bf16_band(kind, band_bf16, num_nodes, W), x, banded_spmm_bf16_kernel)


def banded_spmm_w8a8_kernel(q: QuantizedBandedMatrix, x: torch.Tensor) -> torch.Tensor:
    """Quantize ``x [≥num_nodes, F]`` per node block in torch into the
    feature-major int8 frame (:func:`w8a8_operands`), then launch B2b on
    CUDA tensors, the band padded to a block that is a multiple of 16 where
    it is not one; returns ``[num_nodes, F]`` float32, the plain version bit
    for bit."""
    kind, n, F = "B2b banded_spmm_w8a8", q.num_nodes, x.shape[-1]
    _check_band(kind, q.band_q, q.scales, x.device)
    _check_x(kind, q, x)
    if n == 0 or F == 0:
        return torch.empty((n, F), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        xq_p, xscales = w8a8_operands(q, x)
        out = band_mma.launch_rowmajor_w8a8(kind, band_mma.pad_band(q.band_q), q.scales, xq_p, xscales, n,
                                            q.bandwidth, q.block)
    banded_spmm_w8a8_kernel.launches += 1
    return out


def banded_spmm_quant_fused_dot_kernel(q: QuantizedBandedMatrix, x: torch.Tensor,
                                       wrow_bf16: bool = False) -> torch.Tensor:
    """Launch B2c on CUDA tensors: ``x [≥num_nodes, F]`` float32 with unit
    inner stride, rounded to bfloat16 in the padded frame in torch first,
    and the band padded to a block that is a multiple of 16 where it is not
    one; returns ``[num_nodes, F]`` float32."""
    kind, n, F = "B2c banded_spmm_quant_fused_dot", q.num_nodes, x.shape[-1]
    _check_band(kind, q.band_q, q.scales, x.device)
    _check_x(kind, q, x, torch.float32)
    if n == 0 or F == 0:
        return torch.empty((n, F), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        frame = band_mma.rowmajor_frame(x, n, q.num_blocks, q.bandwidth, q.block)
        out = band_mma.launch_rowmajor(kind, band_mma.pad_band(q.band_q), frame, n, q.bandwidth,
                                       q.block, F, q.scales, wrow_bf16=bool(wrow_bf16))
    banded_spmm_quant_fused_dot_kernel.launches += 1
    return out


banded_spmm_bf16_kernel.launches = 0
banded_spmm_w8a8_kernel.launches = 0
banded_spmm_quant_fused_dot_kernel.launches = 0


# ---------------------------------------------------------------------------
# Entry points: the kernel on CUDA tensors, the plain version on CPU tensors
# ---------------------------------------------------------------------------


def banded_spmm_bf16(band_bf16: torch.Tensor, num_nodes: int, W: int, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` over a bfloat16 band ``[NB, 2W+1, block, block]`` with ``x``
    rounded to bfloat16; ``[num_nodes, F]`` float32."""
    if x.device.type == "cpu":
        return banded_spmm_bf16_reference(band_bf16, num_nodes, W, x)
    return banded_spmm_bf16_kernel(band_bf16, num_nodes, W, x)


def banded_spmm_w8a8(q: QuantizedBandedMatrix, x: torch.Tensor) -> torch.Tensor:
    """``A_q @ x_q``: int8 band by int8 activations quantized here per node
    block, exact int32 dots; ``[num_nodes, F]`` float32."""
    if x.device.type == "cpu":
        return banded_spmm_w8a8_reference(q, x)
    return banded_spmm_w8a8_kernel(q, x)


def banded_spmm_quant_fused_dot(q: QuantizedBandedMatrix, x: torch.Tensor,
                                wrow_bf16: bool = False) -> torch.Tensor:
    """``A_q @ x`` with each tile's scale folded into the tile (rounded to
    bfloat16 with ``wrow_bf16``) and ``x`` rounded to bfloat16;
    ``[num_nodes, F]`` float32."""
    if x.device.type == "cpu":
        return banded_spmm_quant_fused_dot_reference(q, x, wrow_bf16)
    return banded_spmm_quant_fused_dot_kernel(q, x, wrow_bf16)


def banded_spmm_quant_manual(q: QuantizedBandedMatrix, x: torch.Tensor) -> torch.Tensor:
    """``A_q @ x`` through K4 on the feature-major band (its plain version
    on CPU tensors), transposed back to ``[num_nodes, F]``."""
    return banded_spmm_quant_fm(to_feature_major(q), x[: q.num_nodes].T.contiguous()).T
