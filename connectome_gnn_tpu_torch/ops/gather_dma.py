"""Random-row gather B1: the kernel of ``benchmarks/gather_dma_experiments.py``
as a library function.

That script asks how fast ``L`` random rows of an ``[N, F]`` table can be
fetched, the floor under the sampler's gathers and the irregular SpMM.  Its
kernel function ``dma_gather`` is ported here; the script itself (its
chained-loop timing, sweeps and JSON) is not.

:func:`dma_gather` computes ``out[i, :] = table[idx[i], :]`` for ``table
[N, F]`` of any type and ``idx [L]`` int32; the output is ``[L, F]`` in the
table's type.  It is a copy, so kernel and plain version agree bitwise.
``k_outstanding`` (K, the rows each warp keeps in flight) and ``chunk`` (C,
the indices a thread block walks) change no value; K is one of
:data:`K_OUTSTANDING`, the values the script sweeps, and C need not divide
``L`` (the TPU kernel cut C to a divisor of L; the kernel here masks the
ragged last chunk).

An index outside ``[0, N)`` raises ``ValueError``, checked by one device
reduction before the launch: the TPU's DMA leaves that row undefined and
XLA's ``t[i]`` clamps it.  :func:`_launch_gather`, the launch alone for
timing, skips that check.

The kernel is ``csrc/row_gather.cu``.  Beside it sit its plain PyTorch
version (:func:`dma_gather_reference`, the oracle of the tests and of
``chip_smoke.py``) and a launch counter (``dma_gather.launches``).  The
entry point takes the plain version for CPU tensors only; for a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from connectome_gnn_tpu_torch.ops.banded_quant import _launch, _stream

#: the rows in flight per warp that the kernel is built for: the script's ``--ks``
K_OUTSTANDING = (4, 8, 16, 32)
#: the largest chunk whose indices fit the default 48 KB of shared memory
MAX_CHUNK = 12288


def _check(table: torch.Tensor, idx: torch.Tensor, k_outstanding: int, chunk: int) -> None:
    """Operand checks shared by every path (indices not included)."""
    if table.dim() != 2:
        raise ValueError(f"B1 dma_gather: table must be [N, F], got {tuple(table.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"B1 dma_gather: idx must be int32 [L], got {idx.dtype} {tuple(idx.shape)}")
    if idx.device != table.device:
        raise ValueError(f"B1 dma_gather: idx on {idx.device}, table on {table.device}")
    if k_outstanding not in K_OUTSTANDING:
        raise ValueError(f"B1 dma_gather: k_outstanding={k_outstanding} is not one of {K_OUTSTANDING}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"B1 dma_gather: chunk={chunk} is not in [1, {MAX_CHUNK}]")


def _check_indices(table: torch.Tensor, idx: torch.Tensor) -> None:
    """Raise for any index outside ``[0, N)``: one reduction, one sync."""
    if idx.numel() == 0:
        return
    lo, hi = torch.stack(torch.aminmax(idx)).tolist()
    if lo < 0 or hi >= table.shape[0]:
        raise ValueError(f"B1 dma_gather: indices span [{lo}, {hi}], outside [0, {table.shape[0]}) "
                         "(the TPU kernel leaves such rows undefined)")


def dma_gather_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """B1 in plain torch: ``table[idx]``, ``[L, F]`` in the table's type."""
    return table[idx.long()]


def vector_bytes(table: torch.Tensor, out: torch.Tensor) -> int:
    """The widest copy word, 16, 8, 4, 2 or 1 bytes, that divides a row's
    bytes and both base addresses."""
    row_bytes = table.shape[1] * table.element_size()
    v = 16
    while row_bytes % v or table.data_ptr() % v or out.data_ptr() % v:
        v //= 2
    return v


def _launch_gather(table: torch.Tensor, idx: torch.Tensor, k_outstanding: int = 8,
                   chunk: int = 1024) -> torch.Tensor:
    """Launch B1 on CUDA tensors WITHOUT checking the indices' range (the
    launch alone, for timing: an index outside ``[0, N)`` reads outside the
    table).  Counted as a launch of :func:`dma_gather`."""
    _check(table, idx, k_outstanding, chunk)
    if table.device.type != "cuda":
        raise ValueError(f"the B1 dma_gather kernel needs CUDA tensors, got {table.device}")
    if not table.is_contiguous() or not idx.is_contiguous():
        raise ValueError("B1 dma_gather: table and idx must be contiguous")
    L, F = idx.shape[0], table.shape[1]
    out = torch.empty((L, F), dtype=table.dtype, device=table.device)
    if L == 0 or F == 0:
        return out
    with torch.cuda.device(table.device):
        _launch("B1 dma_gather", "cgt_row_gather", table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                L, F * table.element_size(), vector_bytes(table, out), k_outstanding, chunk,
                _stream(table.device))
    dma_gather.launches += 1
    return out


def dma_gather(table: torch.Tensor, idx: torch.Tensor, *, k_outstanding: int = 8,
               chunk: int = 1024) -> torch.Tensor:
    """``table[idx]``: ``[L, F]`` in the table's type, for ``table [N, F]``
    and ``idx [L]`` int32 with every index in ``[0, N)`` (else
    ``ValueError``).  ``k_outstanding`` and ``chunk`` change no value."""
    _check(table, idx, k_outstanding, chunk)
    _check_indices(table, idx)
    if table.device.type == "cpu":
        return dma_gather_reference(table, idx)
    return _launch_gather(table, idx, k_outstanding, chunk)


dma_gather.launches = 0
