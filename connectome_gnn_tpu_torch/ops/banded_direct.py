"""Band SpMM over a float32 or bfloat16 band in one kernel: K7.

The port of ``connectome_gnn_tpu/ops/banded_pallas.py``
(``banded_spmm_pallas``).  ``out[rb] = Σ_d band[rb, d] @ x_blocks[rb + d -
W]`` with ``x[:num_nodes]`` cast to the band's dtype first: a float32 band
keeps ``x`` in float32 and multiplies in full float32 (never TF32); a
bfloat16 band rounds ``x`` to bfloat16 (round to nearest even), so every
product is exact in float32.  The ``2W + 1`` tile products of a row block
are summed in float32, and the output is ``[num_nodes, F]`` float32.

The kernel is role A of the tensor-core body ``csrc/band_mma.cu`` for both
band types.  Over a bfloat16 band the wrapper rounds ``x`` to bfloat16 in
the padded frame in torch first
(:func:`~connectome_gnn_tpu_torch.ops.band_mma.rowmajor_frame`, as the JAX
wrapper does outside its ``pallas_call``).  Over a float32 band it splits
``x`` exactly into three bfloat16 frames, ``x = hi + mid + lo``
(:func:`~connectome_gnn_tpu_torch.ops.band_mma.split_bf16x3`); the kernel
splits each band value the same way in its registers and sums six exact
bfloat16 products a pair (all but mid·lo, lo·mid and lo·lo, each under
2^-24 of the product) in float32.  Limits of that split, which the
wrapper does not check: a non-finite band or ``x`` entry gives NaN where
the plain version may give ±Inf; entries beyond bfloat16's largest finite
value (3.39e38) are out of range, and entries under about 2^-110 in
magnitude (not zero) lose the bits below bfloat16's normal range.

Beside the kernel sit its plain PyTorch version
(:func:`banded_spmm_direct_reference`, the oracle of the tests and of
``chip_smoke.py``) and a launch counter
(``banded_spmm_direct_kernel.launches``).  :func:`banded_spmm_direct` takes
the plain version for CPU tensors only; for a CUDA tensor it launches the
kernel or raises.  Over a float32 band the plain version's float32 sums
round each of a tile's products in turn; the kernel's rounding differs, so
the two differ by the plain version's own rounding error, which at random
data with cancelling sums can exceed 1e-5 (``sum_dtype=torch.float64``
gives the plain version's function without it).

Unlike :func:`~connectome_gnn_tpu_torch.ops.banded.banded_spmm`, which
widens a bfloat16 band but leaves ``x`` in float32 (as the JAX einsum
does), K7 rounds ``x`` to the band's dtype, as the TPU kernel does.  Like
the TPU kernel, nothing on the models' paths calls it.
"""

from __future__ import annotations

import torch

from connectome_gnn_tpu_torch.ops import band_mma
from connectome_gnn_tpu_torch.ops.banded import BandedMatrix, pad_blocks
from connectome_gnn_tpu_torch.ops.banded_quant import _check_activations, _check_band

#: the band dtypes K7 takes
DTYPES = (torch.float32, torch.bfloat16)


def _band_dtype(kind: str, band: torch.Tensor) -> torch.dtype:
    if band.dtype not in DTYPES:
        raise ValueError(f"{kind}: the band must be float32 or bfloat16, got {band.dtype}")
    return band.dtype


def banded_spmm_direct_reference(a: BandedMatrix, x: torch.Tensor,
                                 sum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K7's arithmetic in plain torch: ``A @ x`` with ``x`` cast to the
    band's dtype, float32 products and sums; ``[num_nodes, F]`` float32.
    ``sum_dtype=torch.float64`` takes the products and sums in float64 and
    rounds the result to float32 once: the same function without the
    float32 sums' rounding."""
    dtype = _band_dtype("K7 banded_spmm_direct", a.band)
    nb, W, block, n = a.num_blocks, a.bandwidth, a.block, a.num_nodes
    xb = pad_blocks(x[:n].to(dtype).to(sum_dtype), nb, W, block)
    out = xb.new_zeros((nb, block, xb.shape[2]))
    for d in range(2 * W + 1):
        out += torch.bmm(a.band[:, d].to(sum_dtype), xb[d : d + nb])
    return out.reshape(nb * block, -1)[:n].to(torch.float32)


def launch_direct(kind: str, a: BandedMatrix, x: torch.Tensor, counter) -> torch.Tensor:
    """Check the operands and launch K7, role A of the tensor-core body, on
    CUDA tensors: ``x [≥num_nodes, F]`` float32 with unit inner stride;
    returns ``[num_nodes, F]`` float32.  The launch adds one to
    ``counter.launches``."""
    band, n, F = a.band, a.num_nodes, x.shape[-1]
    _check_band(kind, band, None, x.device, DTYPES)
    if band.shape[1] != 2 * a.bandwidth + 1:
        raise ValueError(f"{kind}: {band.shape[1]} diagonals for bandwidth {a.bandwidth}")
    _check_activations(kind, x, n, F, torch.float32)
    if n == 0 or F == 0:
        return torch.empty((n, F), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        band_p, frame = band_mma.rowmajor_operands(a, x)
        out = band_mma.launch_rowmajor(kind, band_p, frame, n, a.bandwidth, a.block, F)
    counter.launches += 1
    return out


def banded_spmm_direct_kernel(a: BandedMatrix, x: torch.Tensor) -> torch.Tensor:
    """Launch K7 on CUDA tensors: ``A @ x`` for ``x [≥num_nodes, F]``
    float32 and a float32 or bfloat16 band; returns ``[num_nodes, F]``
    float32."""
    return launch_direct("K7 banded_spmm_direct", a, x, banded_spmm_direct_kernel)


banded_spmm_direct_kernel.launches = 0


def banded_spmm_direct(a: BandedMatrix, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` over a float32 or bfloat16 band with ``x`` cast to the
    band's dtype; ``[num_nodes, F]`` float32."""
    if x.device.type == "cpu":
        return banded_spmm_direct_reference(a, x)
    return banded_spmm_direct_kernel(a, x)
