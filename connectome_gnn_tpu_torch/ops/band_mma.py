"""Operands and launches of the tensor-core band body, ``csrc/band_mma.cu``.

That body serves the bfloat16 band kernels: K7 over a bfloat16 band and
B2a (role A, row-major: ``out[rb·b + r] = Σ_d tile[rb, d] @ x̂[rb + d]``)
and B3a's ``fm_bf16_band`` (role B, feature-major, with per-dot scales).
Its products are ``wgmma`` on tiles staged by TMA, and TMA needs 16-byte
global strides.  So the wrappers hand it the band and the frame padded with
zeros where they are not: the block to ``b' = ⌈b/16⌉·16`` and, in role A,
the features to ``F' = ⌈F/8⌉·8``.  Zero senders and receivers change no
sum; the kernel stores only the caller's ``b`` receivers a block and ``F``
features.  At the main shape (``b = 256``, ``F = 64``) nothing is padded.

``x̂`` is ``x[:num_nodes]`` rounded to bfloat16 (round to nearest even) in
the W-shifted padded frame, as ``connectome_gnn_tpu/ops/banded_pallas.py``
hands it to its ``pallas_call``: :func:`rowmajor_frame` builds it in one
pass over ``x`` at the main shape.  :func:`rowmajor_on_operands` and
:func:`fm_on_operands` compute the kernel's function on the prepared
operands in plain torch, so the tests can hold the padding against the
plain versions on the original operands.  The launches here count nothing;
their callers count.
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


def rowmajor_frame(x: torch.Tensor, num_nodes: int, num_blocks: int, bandwidth: int,
                   block: int) -> torch.Tensor:
    """``x[:num_nodes]`` rounded to bfloat16 in the W-shifted padded frame,
    ``[NB + 2W, b', F']``: frame block ``w`` holds nodes ``(w - W)·b ...``,
    zeros elsewhere.  Without padding it is ``banded_pallas.py:45-48``'s
    ``x_pad``, built by one cast-and-copy and zeroing only the halo."""
    n, F = num_nodes, x.shape[1]
    bp, Fp = padded(block, BLOCK_MULTIPLE), padded(F, FEATURE_MULTIPLE)
    blocks = num_blocks + 2 * bandwidth
    if (bp, Fp) == (block, F):
        frame = torch.empty((blocks * block, F), dtype=torch.bfloat16, device=x.device)
        lo = bandwidth * block
        frame[:lo].zero_()
        frame[lo + n :].zero_()
        frame[lo : lo + n] = x[:n]
        return frame.view(blocks, block, F)
    nodes = torch.zeros((num_blocks * block, F), dtype=torch.bfloat16, device=x.device)
    nodes[:n] = x[:n]
    frame = torch.zeros((blocks, bp, Fp), dtype=torch.bfloat16, device=x.device)
    frame[bandwidth : bandwidth + num_blocks, :block, :F] = nodes.view(num_blocks, block, F)
    return frame


def rowmajor_operands(a: BandedMatrix, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Role A's operands of a bfloat16 band: the band and ``x̂``, padded."""
    return pad_band(a.band), rowmajor_frame(x, a.num_nodes, a.num_blocks, a.bandwidth, a.block)


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
                         block: int, F: int) -> torch.Tensor:
    """Role A's function on its prepared operands, in plain torch:
    ``[num_nodes, F]`` float32."""
    nb = band_p.shape[0]
    xw = frame.to(torch.float32)
    out = xw.new_zeros((nb, band_p.shape[2], xw.shape[2]))
    for d in range(2 * W + 1):
        out += torch.bmm(band_p[:, d].to(torch.float32), xw[d : d + nb])
    return out[:, :block, :F].reshape(nb * block, F)[:num_nodes]


def fm_on_operands(band_p: torch.Tensor, scales: torch.Tensor, x_pad_p: torch.Tensor, W: int,
                   block: int) -> torch.Tensor:
    """Role B's function on its prepared operands, in plain torch:
    ``[F, NB·block]`` float32."""
    nb, bp, F = band_p.shape[0], band_p.shape[2], x_pad_p.shape[0]
    xw = x_pad_p.to(torch.float32).view(F, nb + 2 * W, bp).permute(1, 0, 2)
    out = xw.new_zeros((nb, F, bp))
    for d in range(2 * W + 1):
        out += scales[:, d, None, None] * torch.bmm(xw[d : d + nb], band_p[:, d].to(torch.float32))
    return out[:, :, :block].permute(1, 0, 2).reshape(F, nb * block)


def _check(kind: str, band_p: torch.Tensor, frame: torch.Tensor, frame_shape) -> None:
    bp = band_p.shape[2]
    if band_p.dtype != torch.bfloat16 or not band_p.is_contiguous() or bp % BLOCK_MULTIPLE:
        raise ValueError(f"{kind}: the padded band must be contiguous bfloat16 [NB, D, b', b'] with b' "
                         f"a multiple of {BLOCK_MULTIPLE}, got {band_p.dtype} {tuple(band_p.shape)}")
    if (frame.dtype != torch.bfloat16 or not frame.is_contiguous()
            or tuple(frame.shape) != tuple(frame_shape) or frame.device != band_p.device):
        raise ValueError(f"{kind}: the frame must be contiguous bfloat16 {list(frame_shape)} on "
                         f"{band_p.device}, got {frame.dtype} {tuple(frame.shape)}")


def launch_rowmajor(kind: str, band_p: torch.Tensor, frame: torch.Tensor, num_nodes: int, W: int,
                    block: int, F: int) -> torch.Tensor:
    """Role A on CUDA operands from :func:`rowmajor_operands`; returns
    ``[num_nodes, F]`` float32."""
    nb, bp, Fp = band_p.shape[0], band_p.shape[2], frame.shape[-1]
    _check(kind, band_p, frame, (nb + 2 * W, bp, Fp))
    out = torch.empty((num_nodes, F), dtype=torch.float32, device=frame.device)
    _launch(kind, "cgt_banded_spmm_direct_bf16", band_p.data_ptr(), frame.data_ptr(),
            out.data_ptr(), nb, W, block, bp, F, Fp, num_nodes, _stream(frame.device))
    return out


def launch_fm(kind: str, band_p: torch.Tensor, scales: torch.Tensor, x_pad_p: torch.Tensor, W: int,
              block: int) -> torch.Tensor:
    """Role B on CUDA operands (the padded band of transposed tiles, its
    scales, the frame from :func:`fm_frame`); returns ``[F, NB·block]``
    float32."""
    nb, bp, F = band_p.shape[0], band_p.shape[2], x_pad_p.shape[0]
    _check(kind, band_p, x_pad_p, (F, (nb + 2 * W) * bp))
    out = torch.empty((F, nb * block), dtype=torch.float32, device=x_pad_p.device)
    _launch(kind, "cgt_fm_bf16_band", band_p.data_ptr(), scales.data_ptr(), x_pad_p.data_ptr(),
            out.data_ptr(), nb, W, block, bp, F, nb * block, nb * block, _stream(x_pad_p.device))
    return out
