"""Random-row gather B1: the kernel of ``benchmarks/gather_dma_experiments.py``
as a library function.

That script asks how fast ``L`` random rows of an ``[N, F]`` table can be
fetched, the floor under the sampler's gathers and the irregular SpMM.  Its
kernel function ``dma_gather`` is ported here; the script itself (its
chained-loop timing, sweeps and JSON) is not.

:func:`dma_gather` computes ``out[i, :] = table[idx[i], :]`` for ``table
[N, F]`` of any type and ``idx [L]`` int32; the output is ``[L, F]`` in the
table's type.  It is a copy, so kernel and plain version agree bitwise.
``k_outstanding`` (K, the loads each thread keeps in flight) and ``chunk``
(C, the indices a thread block walks) change no value; K is one of
:data:`K_OUTSTANDING`, the values the script sweeps, and C need not divide
``L`` (the TPU kernel cut C to a divisor of L; the kernel here masks the
ragged last chunk).  The kernel copies rows in the widest word that
divides a row and both base addresses (:func:`vector_bytes`);
``csrc/row_gather.cu`` says what bounds it on the card and which designs
were measured against it.

An index outside ``[0, N)``, where the TPU's DMA leaves the row undefined
and XLA's ``t[i]`` clamps it, is an error.  On CPU tensors it raises
``ValueError``.  On the card the kernel checks each index as it loads it
and traps before it reads a row, as ``torch.index_select`` and
``table[idx]`` do there: the call itself returns, the error surfaces as a
CUDA error (``RuntimeError``) at the caller's next synchronizing call, and
the process's CUDA context is unusable after it.  So the entry point never
waits for the card.

The kernel is ``csrc/row_gather.cu``.  Beside it sit its plain PyTorch
version (:func:`dma_gather_reference`, the oracle of the tests and of
``chip_smoke.py``) and a launch counter (``dma_gather.launches``).  The
entry point takes the plain version for CPU tensors only; for a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

#: the values of K the kernels are built for: the script's ``--ks``
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
    """Raise for any index outside ``[0, N)`` (the plain path's check; on
    the card the kernel checks)."""
    if idx.numel() == 0:
        return
    lo, hi = torch.stack(torch.aminmax(idx)).tolist()
    if lo < 0 or hi >= table.shape[0]:
        raise ValueError(f"B1 dma_gather: indices span [{lo}, {hi}], outside [0, {table.shape[0]}) "
                         "(the TPU kernel leaves such rows undefined)")


def dma_gather_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """B1 in plain torch: ``table[idx]``, ``[L, F]`` in the table's type."""
    return table[idx.long()]


def _word(row_bytes: int, table_ptr: int, out_ptr: int) -> int:
    """:func:`vector_bytes` on a row's bytes and the two base addresses."""
    low = row_bytes | table_ptr | out_ptr
    return min(low & -low, 16)


def vector_bytes(table: torch.Tensor, out: torch.Tensor) -> int:
    """The widest copy word, 16, 8, 4, 2 or 1 bytes, that divides a row's
    bytes and both base addresses."""
    return _word(table.shape[1] * table.element_size(), table.data_ptr(), out.data_ptr())


@functools.cache
def _entry():
    """B1's C entry point (the kernels are built on the first call)."""
    from connectome_gnn_tpu_torch.ops._build import library

    return library().cgt_row_gather


def _launch_gather(table: torch.Tensor, idx: torch.Tensor, k_outstanding: int = 8,
                   chunk: int = 1024) -> torch.Tensor:
    """Launch B1 on CUDA tensors: :func:`dma_gather`'s path on the card,
    with no host sync (the kernel checks the indices).  Counted as a launch
    of :func:`dma_gather`."""
    _check(table, idx, k_outstanding, chunk)
    if not table.is_cuda:
        raise ValueError(f"the B1 dma_gather kernel needs CUDA tensors, got {table.device}")
    if not table.is_contiguous() or not idx.is_contiguous():
        raise ValueError("B1 dma_gather: table and idx must be contiguous")
    (N, F), L = table.shape, idx.shape[0]
    out = table.new_empty((L, F))
    if L == 0 or F == 0:
        return out
    if N == 0:
        raise ValueError(f"B1 dma_gather: {L} indices into a table of 0 rows")
    device = table.get_device()
    if device != torch.cuda.current_device():  # a launch goes to the current device
        with torch.cuda.device(device):
            return _launch_gather(table, idx, k_outstanding, chunk)
    row_bytes, table_ptr, out_ptr = F * table.element_size(), table.data_ptr(), out.data_ptr()
    err = _entry()(table_ptr, idx.data_ptr(), out_ptr, L, N, row_bytes, _word(row_bytes, table_ptr, out_ptr),
                   k_outstanding, chunk, torch._C._cuda_getCurrentRawStream(device))
    if err:
        from connectome_gnn_tpu_torch.ops._build import library

        raise RuntimeError(f"B1 dma_gather kernel launch failed: {library().cgt_error_string(err).decode()}")
    dma_gather.launches += 1
    return out


def dma_gather(table: torch.Tensor, idx: torch.Tensor, *, k_outstanding: int = 8,
               chunk: int = 1024) -> torch.Tensor:
    """``table[idx]``: ``[L, F]`` in the table's type, for ``table [N, F]``
    and ``idx [L]`` int32 with every index in ``[0, N)``.  An index outside
    raises ``ValueError`` on CPU tensors; on CUDA tensors the kernel traps,
    and the error surfaces at the next synchronizing call (see the module
    docstring).  ``k_outstanding`` and ``chunk`` change no value."""
    if not table.is_cpu:
        return _launch_gather(table, idx, k_outstanding, chunk)
    _check(table, idx, k_outstanding, chunk)
    _check_indices(table, idx)
    return dma_gather_reference(table, idx)


dma_gather.launches = 0
