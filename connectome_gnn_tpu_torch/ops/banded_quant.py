"""Int8-quantized banded SpMM: the kernels K3, K4, K5 and K6.

The port of ``connectome_gnn_tpu/ops/banded_quant.py``.  The band is
stored as int8 with one float32 scale per (row block, diagonal) tile,
``band ≈ band_q · scales[..., None, None]``: four times fewer band bytes
than float32.  Four hand-written CUDA kernels (``csrc/banded_spmm.cu``)
contract it with the activations:

=====  ==================================  =======================================
K3     :func:`banded_spmm_quant`           ``A_q·x``, row-major ``x [N, F]``
K4     :func:`banded_spmm_quant_fm`        ``(A_q·x)ᵀ``, feature-major ``xT [F, N]``
K5     :func:`banded_spmm_quant_fm_w8a8`   K4 on int8 activations
K6     :func:`banded_spmm_quant_blocked`   K4 on blocked ``xb [NB + 2W, F, block]``
=====  ==================================  =======================================

Training differentiates through the band with two autograd Functions, the
port of the JAX package's ``custom_vjp``s: :func:`banded_spmm_quant_fm_grad`
runs K4 forward and K4 over the transposed band backward (``x̄ = Aᵀ·ȳ``),
:func:`banded_spmm_quant_blocked_grad` runs K6 both ways.  The transposed
band comes from :func:`transposed_feature_major` at prepare time; the band
gets no gradient.

The arithmetic is the JAX package's (``tests/test_banded_quant.py``,
``_emulate``): int8 tile values are exact in float32; K3 and K4 round x to
bfloat16 (round to nearest even), so every product is exact in float32;
each tile's dot is summed in float32, multiplied by its scale, and the
tiles are summed in float32.  K5 quantizes the padded activations per
column block (:func:`quantize_activations_fm`), takes each tile's dot
exactly in int32, and applies ``(scale[rb, d] · xscale[rb + d]) ·
float(dot)``; its activation scale is indexed in the W-shifted padded
frame.

K6 reads the whole padded block frame, the tail past ``num_nodes``
included, as the TPU kernel does: its senders are not masked by
``num_nodes`` (K3-K5 mask them).

Beside each kernel sits its plain PyTorch version (``*_reference``, the
oracle of the tests and of ``chip_smoke.py``) and a launch counter
(``banded_spmm_quant_kernel.launches`` and its siblings, plain integers
that grow by one per launch; ``banded_spmm_quant_fm_grad_kernel.launches``
counts K4's backward launches, which K4's own count includes).  The entry
points take the plain version for CPU tensors only; for a CUDA tensor they
launch the kernel or raise.

The TPU kernels' ``interpret``, ``rows_per_step`` and ``depth`` arguments
are gone: they switch Pallas emulation and TPU panel tiling, and the
result depends on them only through the order of a float32 sum.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from connectome_gnn_tpu_torch.ops.banded import (
    BandedMatrix,
    HybridMatrix,
    _shift_diagonals,
    banded_spmm,
    pad_blocks,
    remainder_spmm,
)

#: largest block for which K5's plain version is exact: its float32 dot of
#: int8 values stays below 2^24 while 127² · block < 2^24
MAX_EXACT_W8A8_BLOCK = 1040
#: grid limits of the launch: x is one block per (row block, 64-receiver
#: tile), y one per 64-feature slice (see csrc/banded_spmm.cu)
TILE_M = TILE_N = 64
MAX_GRID_X = 2**31 - 1
MAX_GRID_Y = 65535


class QuantizedBandedMatrix(NamedTuple):
    """Per-tile symmetric int8 quantization of a :class:`BandedMatrix`:
    ``band_q [NB, 2W+1, block, block]`` int8 (receiver-major tiles) and
    ``scales [NB, 2W+1]`` float32."""

    band_q: torch.Tensor
    scales: torch.Tensor
    num_nodes: int
    bandwidth: int

    @property
    def block(self) -> int:
        return int(self.band_q.shape[2])

    @property
    def num_blocks(self) -> int:
        return int(self.band_q.shape[0])


class QuantizedBandedMatrixFM(NamedTuple):
    """Feature-major (serving-layout) form: ``band_qT`` holds each tile
    transposed, ``[NB, 2W+1, block(sender), block(receiver)]``, so the SpMM
    runs as ``outT = xT_window @ tileT`` on activations ``[F, N]``."""

    band_qT: torch.Tensor
    scales: torch.Tensor
    num_nodes: int
    bandwidth: int

    @property
    def block(self) -> int:
        return int(self.band_qT.shape[2])

    @property
    def num_blocks(self) -> int:
        return int(self.band_qT.shape[0])


class QuantizedHybridMatrix(NamedTuple):
    """Hybrid form with an int8 band; the small remainder stays float32."""

    band: QuantizedBandedMatrix
    remainder_senders: torch.Tensor
    remainder_receivers: torch.Tensor
    remainder_weights: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.band.num_nodes


# ---------------------------------------------------------------------------
# Quantization and layouts
# ---------------------------------------------------------------------------


def _symmetric_int8(x: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    """``clip(round(x / scale), ±127)`` as int8, ``scale`` broadcast to ``x``
    as ``shape``."""
    return torch.div(x, scale.view(shape)).round_().clamp_(-127, 127).to(torch.int8)


def quantize_band(a: BandedMatrix) -> QuantizedBandedMatrix:
    """Symmetric per-tile int8 quantization, bitwise equal to the JAX
    package's: the entry error is at most ``scales / 2``; all-zero tiles get
    scale 1.  One diagonal at a time, so the float32 temporary is a fifth
    of the band at W = 2."""
    band = a.band
    band_q = torch.empty(band.shape, dtype=torch.int8, device=band.device)
    scales = torch.empty(band.shape[:2], dtype=torch.float32, device=band.device)
    # XLA compiles the JAX package's jitted ``maxabs / 127`` into a multiply
    # by the float32 reciprocal; the eager activation quantizer divides
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=band.device)
    for d in range(band.shape[1]):
        tiles = band[:, d]
        maxabs = torch.maximum(tiles.amax(dim=(1, 2)), -tiles.amin(dim=(1, 2)))
        scales[:, d] = torch.where(maxabs > 0, maxabs * inv127, torch.ones_like(maxabs))
        band_q[:, d] = _symmetric_int8(tiles, scales[:, d], (-1, 1, 1))
    return QuantizedBandedMatrix(band_q, scales, a.num_nodes, a.bandwidth)


def dequantize_band(q: QuantizedBandedMatrix) -> BandedMatrix:
    """float32 band reconstruction."""
    band = q.band_q.to(torch.float32) * q.scales[:, :, None, None]
    return BandedMatrix(band, q.num_nodes, q.bandwidth)


def banded_spmm_quant_xla(q: QuantizedBandedMatrix, x: torch.Tensor) -> torch.Tensor:
    """``A_q @ x`` by dequantizing, then the float32 band SpMM: float32
    activations, where K3 rounds them to bfloat16.  (The JAX package's
    XLA baseline, under its name there.)"""
    return banded_spmm(dequantize_band(q), x)


def quantize_hybrid(h: HybridMatrix) -> QuantizedHybridMatrix:
    """Quantize a hybrid matrix's band; the remainder stays float32."""
    return QuantizedHybridMatrix(
        quantize_band(h.band), h.remainder_senders, h.remainder_receivers,
        h.remainder_weights,
    )


def to_feature_major(q: QuantizedBandedMatrix) -> QuantizedBandedMatrixFM:
    """One-time serving prep: transpose each int8 tile (sender-major)."""
    return QuantizedBandedMatrixFM(
        q.band_q.transpose(2, 3).contiguous(), q.scales, q.num_nodes, q.bandwidth
    )


def transpose_quantized(q: QuantizedBandedMatrix) -> QuantizedBandedMatrix:
    """``Aᵀ`` of an int8 band, bitwise equal to the JAX package's: the tile
    geometry of :func:`~connectome_gnn_tpu_torch.ops.banded.
    transpose_banded`, the scales travelling with their tiles (per-tile
    max-abs is transpose-invariant, so this equals quantizing the float32
    transpose), scale 1 on the shifted-in zero tiles."""
    return QuantizedBandedMatrix(
        _shift_diagonals(q.band_q, transpose_tiles=True), _shift_diagonals(q.scales, fill=1.0),
        q.num_nodes, q.bandwidth,
    )


def transposed_feature_major(q: QuantizedBandedMatrix) -> QuantizedBandedMatrixFM:
    """``to_feature_major(transpose_quantized(q))``, the backward operand of
    training, without transposing a tile: the two tile transposes cancel,
    so ``band_qT[cb, d]`` is ``q.band_q[cb + d - W, 2W - d]`` as stored.
    One int8 band-sized copy, where the two-step route copies twice and
    transposes 1.34 GB of tiles at a million nodes."""
    return QuantizedBandedMatrixFM(
        _shift_diagonals(q.band_q), _shift_diagonals(q.scales, fill=1.0), q.num_nodes, q.bandwidth
    )


def quantize_transposed_fm(band_norm: BandedMatrix) -> QuantizedBandedMatrixFM:
    """Feature-major quantization of ``Aᵀ``, the backward operand of the
    trainable quantized SpMM; bitwise equal to the JAX package's."""
    return transposed_feature_major(quantize_band(band_norm))


def to_blocked(xT_pad: torch.Tensor, block: int) -> torch.Tensor:
    """``[F, NB·block]`` feature-major → ``[NB, F, block]`` blocked, the
    layout of K6 (contiguous)."""
    F, total = xT_pad.shape
    return xT_pad.reshape(F, total // block, block).transpose(0, 1).contiguous()


def from_blocked(xb: torch.Tensor) -> torch.Tensor:
    """``[NB, F, block]`` blocked → ``[F, NB·block]`` feature-major."""
    nb, F, block = xb.shape
    return xb.transpose(0, 1).reshape(F, nb * block)


def _pad_blocked(xb: torch.Tensor, W: int) -> torch.Tensor:
    """``W`` zero blocks on each side of the node-block axis: the W-shifted
    padded frame that K6 reads."""
    if W == 0:
        return xb
    return torch.nn.functional.pad(xb, (0, 0, 0, 0, W, W))


def quantize_activations_fm(xT_pad: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-column-block symmetric int8 quantization of padded feature-major
    activations, bitwise equal to the JAX package's: ``[F, NBwin·block]`` →
    int8 of the same shape, and one float32 scale per column block
    (max-abs / 127; all-zero blocks get scale 1)."""
    F, total = xT_pad.shape
    xb = xT_pad.to(torch.float32).reshape(F, total // block, block)
    maxabs = xb.abs().amax(dim=(0, 2))
    scale = torch.where(maxabs > 0, maxabs / 127.0, torch.ones_like(maxabs))
    return _symmetric_int8(xb, scale, (1, -1, 1)).reshape(F, total), scale


def _pad_fm(xT: torch.Tensor, num_blocks: int, bandwidth: int, block: int, dtype) -> torch.Tensor:
    """``xT[:, :n]`` cast to ``dtype`` in the W-shifted padded frame,
    ``[F, (NB + 2W)·block]``."""
    n = xT.shape[1]
    xT_pad = torch.zeros(
        (xT.shape[0], (num_blocks + 2 * bandwidth) * block), dtype=dtype, device=xT.device
    )
    xT_pad[:, bandwidth * block : bandwidth * block + n] = xT
    return xT_pad


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the oracle; TF32 must be off on the card)
# ---------------------------------------------------------------------------


def banded_spmm_quant_reference(q: QuantizedBandedMatrix, x: torch.Tensor) -> torch.Tensor:
    """K3's arithmetic in plain torch: ``A_q @ x``, ``[num_nodes, F]`` f32."""
    nb, W, block, n = q.num_blocks, q.bandwidth, q.block, q.num_nodes
    # bf16 rounding first, then float32: bf16 × int8 products are exact
    xb = pad_blocks(x[:n].to(torch.bfloat16).to(torch.float32), nb, W, block)
    out = xb.new_zeros((nb, block, xb.shape[2]))
    for d in range(2 * W + 1):
        dots = torch.bmm(q.band_q[:, d].to(torch.float32), xb[d : d + nb])
        out += q.scales[:, d, None, None] * dots
    return out.reshape(nb * block, -1)[:n]


def _fm_windows(x_pad: torch.Tensor, num_blocks: int, bandwidth: int, block: int) -> torch.Tensor:
    """``[F, (NB + 2W)·block]`` → float32 blocks ``[NB + 2W, F, block]``."""
    F = x_pad.shape[0]
    blocks = x_pad.to(torch.float32).view(F, num_blocks + 2 * bandwidth, block)
    return blocks.permute(1, 0, 2).contiguous()


def _fm_output(out: torch.Tensor, n: int) -> torch.Tensor:
    """``[NB, F, block]`` → ``[F, n]``."""
    nb, F, block = out.shape
    return out.permute(1, 0, 2).reshape(F, nb * block)[:, :n]


def _windows_times_band(q: QuantizedBandedMatrixFM, xw: torch.Tensor) -> torch.Tensor:
    """``Σ_d scale[:, d] · (xw[d : d + NB] @ tileT[:, d])`` over float32
    windows ``xw [NB + 2W, F, block]``: ``[NB, F, block]`` float32."""
    nb = q.num_blocks
    out = xw.new_zeros((nb, xw.shape[1], q.block))
    for d in range(2 * q.bandwidth + 1):
        dots = torch.bmm(xw[d : d + nb], q.band_qT[:, d].to(torch.float32))
        out += q.scales[:, d, None, None] * dots
    return out


def banded_spmm_quant_fm_reference(q: QuantizedBandedMatrixFM, xT: torch.Tensor) -> torch.Tensor:
    """K4's arithmetic in plain torch: ``(A_q @ x)ᵀ``, ``[F, num_nodes]`` f32."""
    nb, W, block, n = q.num_blocks, q.bandwidth, q.block, q.num_nodes
    xw = _fm_windows(_pad_fm(xT[:, :n], nb, W, block, torch.bfloat16), nb, W, block)
    return _fm_output(_windows_times_band(q, xw), n)


def _check_blocked(kind: str, q: QuantizedBandedMatrixFM, xb_pad: torch.Tensor) -> None:
    want = (q.num_blocks + 2 * q.bandwidth, q.block)
    if xb_pad.dim() != 3 or (xb_pad.shape[0], xb_pad.shape[2]) != want:
        raise ValueError(f"{kind}: activations must be [{want[0]}, F, {want[1]}], "
                         f"got {tuple(xb_pad.shape)}")


def banded_spmm_quant_blocked_reference(q: QuantizedBandedMatrixFM, xb_pad: torch.Tensor) -> torch.Tensor:
    """K6's arithmetic in plain torch: ``A_q @ x`` on blocked activations
    ``xb_pad [NB + 2W, F, block]`` in the W-shifted padded frame, rounded
    to bf16; returns ``[NB, F, block]`` f32.  The whole frame is read, the
    tail past ``num_nodes`` included, as the TPU kernel reads it."""
    _check_blocked("K6 banded_spmm_quant_blocked", q, xb_pad)
    return _windows_times_band(q, xb_pad.to(torch.bfloat16).to(torch.float32))


def quantize_activations_padded(q: QuantizedBandedMatrixFM, xT: torch.Tensor):
    """K5's activation operands: ``xT[:, :n]`` in the W-shifted padded frame,
    quantized per column block; ``(xq [F, (NB+2W)·block] int8,
    xscales [NB+2W])``.  The halo blocks are zero and get scale 1."""
    nb, W, block, n = q.num_blocks, q.bandwidth, q.block, q.num_nodes
    return quantize_activations_fm(_pad_fm(xT[:, :n], nb, W, block, torch.float32), block)


def banded_spmm_quant_fm_w8a8_reference(q: QuantizedBandedMatrixFM, xT: torch.Tensor) -> torch.Tensor:
    """K5's arithmetic in plain torch: ``(A_q @ x_q)ᵀ``, ``[F, num_nodes]``.

    The int8 dots run as float32 products of int8 values, exact while
    ``127² · block < 2^24``; larger blocks raise ``ValueError``."""
    nb, W, block, n = q.num_blocks, q.bandwidth, q.block, q.num_nodes
    if block > MAX_EXACT_W8A8_BLOCK:
        raise ValueError(
            f"block {block} > {MAX_EXACT_W8A8_BLOCK}: the float32 int8 dot is no longer exact"
        )
    return w8a8_windows_times_band(q, *quantize_activations_padded(q, xT))


def w8a8_windows_times_band(q: QuantizedBandedMatrixFM, xq: torch.Tensor,
                            xscales: torch.Tensor) -> torch.Tensor:
    """K5's arithmetic on given operands: int8 ``xq [F, (NB + 2W)·block]``
    in the W-shifted padded frame and its block scales ``[NB + 2W]``;
    ``Σ_d (scale[rb, d] · xscale[rb + d]) · dot`` as ``[F, num_nodes]``."""
    nb, W, block, n = q.num_blocks, q.bandwidth, q.block, q.num_nodes
    xw = _fm_windows(xq, nb, W, block)
    out = xw.new_zeros((nb, xw.shape[1], block))
    for d in range(2 * W + 1):
        dots = torch.bmm(xw[d : d + nb], q.band_qT[:, d].to(torch.float32))
        s = q.scales[:, d] * xscales[d : d + nb]
        out += s[:, None, None] * dots
    return _fm_output(out, n)


# ---------------------------------------------------------------------------
# Kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


def _check_band(kind: str, band: torch.Tensor, scales: torch.Tensor | None, device,
                dtypes=(torch.int8,)) -> None:
    """Check a band ``[NB, 2W+1, b, b]`` of one of ``dtypes`` and its
    scales ``[NB, 2W+1]`` (``None`` for a band without scales) for a launch
    on ``device``."""
    if device.type != "cuda":
        raise ValueError(f"the {kind} kernel needs CUDA tensors, got {device}")
    nb, D, b, b2 = band.shape
    if band.dtype not in dtypes or b != b2 or D % 2 != 1 or not band.is_contiguous():
        names = " or ".join(str(t).removeprefix("torch.") for t in dtypes)
        raise ValueError(f"{kind}: band must be contiguous {names} [NB, 2W+1, b, b], got "
                         f"{band.dtype} {tuple(band.shape)}")
    if scales is not None and (scales.dtype != torch.float32 or tuple(scales.shape) != (nb, D)
                               or not scales.is_contiguous()):
        raise ValueError(f"{kind}: scales must be contiguous float32 [{nb}, {D}]")
    if band.device != device or (scales is not None and scales.device != device):
        raise ValueError(f"{kind}: band, scales and activations must share {device}")
    if nb * -(-b // TILE_M) > MAX_GRID_X:
        raise ValueError(f"{kind}: {nb} row blocks of {b} exceed the launch grid")


def _check_activations(kind: str, x: torch.Tensor, rows: int, cols: int, dtype) -> None:
    if x.dtype != dtype or x.dim() != 2 or x.stride(1) != 1:
        raise ValueError(f"{kind}: activations must be {dtype} [*, *] with unit inner stride, "
                         f"got {x.dtype} {tuple(x.shape)} strides {x.stride()}")
    if x.shape[0] < rows or x.shape[1] < cols:
        raise ValueError(f"{kind}: activations {tuple(x.shape)} smaller than [{rows}, {cols}]")


def _launch(kind: str, entry: str, *args) -> None:
    from connectome_gnn_tpu_torch.ops._build import library

    lib = library()
    err = getattr(lib, entry)(*args)
    if err != 0:
        raise RuntimeError(f"{kind} kernel launch failed: {lib.cgt_error_string(err).decode()}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def banded_spmm_quant_kernel(q: QuantizedBandedMatrix, x: torch.Tensor) -> torch.Tensor:
    """Launch K3 on CUDA tensors: ``A_q @ x`` for ``x [≥num_nodes, F]``
    float32; returns ``[num_nodes, F]`` float32."""
    kind, n, F = "K3 banded_spmm_quant", q.num_nodes, x.shape[-1]
    _check_band(kind, q.band_q, q.scales, x.device)
    _check_activations(kind, x, n, F, torch.float32)
    if -(-F // TILE_N) > MAX_GRID_Y:
        raise ValueError(f"{kind}: F={F} exceeds the launch grid")
    out = torch.empty((n, F), dtype=torch.float32, device=x.device)
    if n == 0 or F == 0:
        return out
    with torch.cuda.device(x.device):
        _launch(kind, "cgt_banded_spmm_quant", q.band_q.data_ptr(), q.scales.data_ptr(),
                x.data_ptr(), out.data_ptr(), q.num_blocks, q.bandwidth, q.block, F, n,
                x.stride(0), _stream(x.device))
    banded_spmm_quant_kernel.launches += 1
    return out


def banded_spmm_quant_fm_kernel(q: QuantizedBandedMatrixFM, xT: torch.Tensor) -> torch.Tensor:
    """Launch K4 on CUDA tensors: ``(A_q @ x)ᵀ`` for ``xT [F, ≥num_nodes]``
    float32; returns ``[F, num_nodes]`` float32."""
    kind, n, F = "K4 banded_spmm_quant_fm", q.num_nodes, xT.shape[0]
    _check_band(kind, q.band_qT, q.scales, xT.device)
    _check_activations(kind, xT, F, n, torch.float32)
    if -(-F // TILE_N) > MAX_GRID_Y:
        raise ValueError(f"{kind}: F={F} exceeds the launch grid")
    out = torch.empty((F, n), dtype=torch.float32, device=xT.device)
    if n == 0 or F == 0:
        return out
    with torch.cuda.device(xT.device):
        _launch(kind, "cgt_banded_spmm_quant_fm", q.band_qT.data_ptr(), q.scales.data_ptr(),
                xT.data_ptr(), out.data_ptr(), q.num_blocks, q.bandwidth, q.block, F, n,
                xT.stride(0), _stream(xT.device))
    banded_spmm_quant_fm_kernel.launches += 1
    return out


def banded_spmm_quant_fm_w8a8_kernel(q: QuantizedBandedMatrixFM, xT: torch.Tensor) -> torch.Tensor:
    """Quantize ``xT [F, ≥num_nodes]`` per column block in torch, then launch
    K5 on CUDA tensors; returns ``[F, num_nodes]`` float32."""
    kind, n, F = "K5 banded_spmm_quant_fm_w8a8", q.num_nodes, xT.shape[0]
    _check_band(kind, q.band_qT, q.scales, xT.device)
    if xT.dim() != 2 or xT.shape[1] < n:
        raise ValueError(f"{kind}: activations {tuple(xT.shape)} are not [F, ≥{n}]")
    if -(-F // TILE_N) > MAX_GRID_Y:
        raise ValueError(f"{kind}: F={F} exceeds the launch grid")
    out = torch.empty((F, n), dtype=torch.float32, device=xT.device)
    if n == 0 or F == 0:
        return out
    xq, xscales = quantize_activations_padded(q, xT)
    with torch.cuda.device(xT.device):
        _launch(kind, "cgt_banded_spmm_quant_fm_w8a8", q.band_qT.data_ptr(),
                q.scales.data_ptr(), xq.data_ptr(), xscales.data_ptr(), out.data_ptr(),
                q.num_blocks, q.bandwidth, q.block, F, n, xq.stride(0), _stream(xT.device))
    banded_spmm_quant_fm_w8a8_kernel.launches += 1
    return out


def banded_spmm_quant_fm_grad_kernel(qT: QuantizedBandedMatrixFM, gT: torch.Tensor) -> torch.Tensor:
    """K4's backward launch: K4 over the transposed band, ``x̄ᵀ = (Aᵀ·ȳ)ᵀ``
    for the cotangent ``gT [F, ≥num_nodes]`` float32.  Counted here and,
    being K4, in K4's count too."""
    before = banded_spmm_quant_fm_kernel.launches
    out = banded_spmm_quant_fm_kernel(qT, gT)
    banded_spmm_quant_fm_grad_kernel.launches += banded_spmm_quant_fm_kernel.launches - before
    return out


def banded_spmm_quant_blocked_kernel(q: QuantizedBandedMatrixFM, xb_pad: torch.Tensor) -> torch.Tensor:
    """Launch K6 on CUDA tensors: ``A_q @ x`` for contiguous float32
    ``xb_pad [NB + 2W, F, block]``; returns ``[NB, F, block]`` float32."""
    kind = "K6 banded_spmm_quant_blocked"
    _check_band(kind, q.band_qT, q.scales, xb_pad.device)
    _check_blocked(kind, q, xb_pad)
    F = xb_pad.shape[1]
    if xb_pad.dtype != torch.float32 or not xb_pad.is_contiguous():
        raise ValueError(f"{kind}: activations must be contiguous float32, got {xb_pad.dtype} "
                         f"strides {xb_pad.stride()}")
    if -(-F // TILE_N) > MAX_GRID_Y:
        raise ValueError(f"{kind}: F={F} exceeds the launch grid")
    out = torch.empty((q.num_blocks, F, q.block), dtype=torch.float32, device=xb_pad.device)
    if F == 0:
        return out
    with torch.cuda.device(xb_pad.device):
        _launch(kind, "cgt_banded_spmm_quant_blocked", q.band_qT.data_ptr(), q.scales.data_ptr(),
                xb_pad.data_ptr(), out.data_ptr(), q.num_blocks, q.bandwidth, q.block, F,
                _stream(xb_pad.device))
    banded_spmm_quant_blocked_kernel.launches += 1
    return out


banded_spmm_quant_kernel.launches = 0
banded_spmm_quant_fm_kernel.launches = 0
banded_spmm_quant_fm_w8a8_kernel.launches = 0
banded_spmm_quant_fm_grad_kernel.launches = 0
banded_spmm_quant_blocked_kernel.launches = 0


# ---------------------------------------------------------------------------
# Entry points: the kernel on CUDA tensors, the plain version on CPU tensors
# ---------------------------------------------------------------------------


def banded_spmm_quant(q: QuantizedBandedMatrix, x: torch.Tensor) -> torch.Tensor:
    """``A_q @ x``, ``[num_nodes, F]`` float32 (int8 band, bf16 x, f32 sums)."""
    if x.device.type == "cpu":
        return banded_spmm_quant_reference(q, x)
    return banded_spmm_quant_kernel(q, x)


def banded_spmm_quant_fm(q: QuantizedBandedMatrixFM, xT: torch.Tensor) -> torch.Tensor:
    """``(A_q @ x)ᵀ`` on feature-major activations ``xT [F, num_nodes]``;
    returns ``[F, num_nodes]`` float32."""
    if xT.device.type == "cpu":
        return banded_spmm_quant_fm_reference(q, xT)
    return banded_spmm_quant_fm_kernel(q, xT)


def banded_spmm_quant_fm_w8a8(q: QuantizedBandedMatrixFM, xT: torch.Tensor) -> torch.Tensor:
    """:func:`banded_spmm_quant_fm` with int8 activations, quantized here per
    column block; returns ``[F, num_nodes]`` float32."""
    if xT.device.type == "cpu":
        return banded_spmm_quant_fm_w8a8_reference(q, xT)
    return banded_spmm_quant_fm_w8a8_kernel(q, xT)


def _fm_backward(qT: QuantizedBandedMatrixFM, gT: torch.Tensor) -> torch.Tensor:
    """K4's backward launch on CUDA tensors, its plain version on CPU ones."""
    if gT.device.type == "cpu":
        return banded_spmm_quant_fm_reference(qT, gT)
    return banded_spmm_quant_fm_grad_kernel(qT, gT)


def banded_spmm_quant_blocked(q: QuantizedBandedMatrixFM, xb_pad: torch.Tensor) -> torch.Tensor:
    """``A_q @ x`` on blocked activations ``xb_pad [NB + 2W, F, block]``;
    returns ``[NB, F, block]`` float32."""
    if xb_pad.device.type == "cpu":
        return banded_spmm_quant_blocked_reference(q, xb_pad)
    return banded_spmm_quant_blocked_kernel(q, xb_pad)


def hybrid_spmm_quant(a: QuantizedHybridMatrix, x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """``A @ x`` for the quantized hybrid form: the int8 band through K3
    (its plain version with ``plain=True``), plus the float32 remainder."""
    band = banded_spmm_quant_reference if plain else banded_spmm_quant
    return band(a.band, x) + remainder_spmm(a, x)


def serving_spmm(adj_q, *, w8a8: bool = False, plain: bool = False):
    """The band SpMM that serves a prepared adjacency: K4 (K5 with ``w8a8``)
    for a :class:`QuantizedBandedMatrixFM`, K3 for a
    :class:`QuantizedBandedMatrix`, K3 plus the remainder for a
    :class:`QuantizedHybridMatrix`.  ``plain=True`` takes the plain
    versions on any device (the oracle of the kernels on the card).
    ``w8a8`` needs a feature-major adjacency and raises ``ValueError``
    otherwise."""
    if isinstance(adj_q, QuantizedBandedMatrixFM):
        if w8a8:
            return banded_spmm_quant_fm_w8a8_reference if plain else banded_spmm_quant_fm_w8a8
        return banded_spmm_quant_fm_reference if plain else banded_spmm_quant_fm
    if w8a8:
        raise ValueError(
            "w8a8 serving requires a feature-major adjacency "
            "(prepare_quantized(..., feature_major=True))"
        )
    if isinstance(adj_q, QuantizedHybridMatrix):
        return lambda a, x: hybrid_spmm_quant(a, x, plain=plain)
    return banded_spmm_quant_reference if plain else banded_spmm_quant


# ---------------------------------------------------------------------------
# Trainable wrappers: the JAX package's custom VJPs as autograd Functions
# ---------------------------------------------------------------------------


class _FmTrainable(torch.autograd.Function):
    """``(A_q @ x)ᵀ`` by K4; backward ``x̄ᵀ = (Aᵀ·ȳ)ᵀ`` by K4 over ``qT``."""

    @staticmethod
    def forward(ctx, xT, q, qT, plain):
        ctx.qT, ctx.plain, ctx.cols = qT, plain, xT.shape[1]
        return (banded_spmm_quant_fm_reference if plain else banded_spmm_quant_fm)(q, xT)

    @staticmethod
    def backward(ctx, gT):
        # K4 takes activations with unit inner stride
        spmm = banded_spmm_quant_fm_reference if ctx.plain else _fm_backward
        dxT = spmm(ctx.qT, gT.contiguous())
        if ctx.cols > dxT.shape[1]:  # columns past num_nodes never entered the forward
            dxT = torch.cat([dxT, dxT.new_zeros((dxT.shape[0], ctx.cols - dxT.shape[1]))], dim=1)
        return dxT, None, None, None


class _BlockedTrainable(torch.autograd.Function):
    """``A_q @ x`` on blocked activations by K6; backward by K6 over ``qT``."""

    @staticmethod
    def forward(ctx, xb, q, qT, plain):
        ctx.qT, ctx.plain = qT, plain
        spmm = banded_spmm_quant_blocked_reference if plain else banded_spmm_quant_blocked
        return spmm(q, _pad_blocked(xb, q.bandwidth))

    @staticmethod
    def backward(ctx, gb):
        qT = ctx.qT
        spmm = banded_spmm_quant_blocked_reference if ctx.plain else banded_spmm_quant_blocked
        return spmm(qT, _pad_blocked(gb.contiguous(), qT.bandwidth)), None, None, None


def _check_pair(q: QuantizedBandedMatrixFM, qT: QuantizedBandedMatrixFM) -> None:
    if q.num_nodes != qT.num_nodes or q.bandwidth != qT.bandwidth:
        raise ValueError("q and qT disagree on geometry")


def banded_spmm_quant_fm_grad(
    q: QuantizedBandedMatrixFM, qT: QuantizedBandedMatrixFM, xT: torch.Tensor, *, plain: bool = False
) -> torch.Tensor:
    """Trainable :func:`banded_spmm_quant_fm`: ``(A_q @ x)ᵀ``, ``[F,
    num_nodes]``, differentiable in ``xT``.  Forward K4 on ``q``, backward
    K4 on ``qT`` (from :func:`transposed_feature_major`) over the
    cotangent; ``q`` and ``qT`` get no gradient.  ``plain=True`` runs the
    plain versions both ways on any device."""
    _check_pair(q, qT)
    return _FmTrainable.apply(xT, q, qT, plain)


def banded_spmm_quant_blocked_grad(
    q: QuantizedBandedMatrixFM, qT: QuantizedBandedMatrixFM, xb: torch.Tensor, *, plain: bool = False
) -> torch.Tensor:
    """Trainable K6 on unpadded blocked activations ``xb [NB, F, block]``:
    ``A_q @ x`` as ``[NB, F, block]``, differentiable in ``xb``; the
    backward runs K6 on ``qT`` over the padded cotangent.  ``plain=True``
    runs the plain versions both ways on any device."""
    _check_pair(q, qT)
    return _BlockedTrainable.apply(xb, q, qT, plain)
