"""The random-row gather kernel B1 (``ops/gather_dma.py``,
``csrc/row_gather.cu``) against its plain PyTorch version, on the card.

Every test here needs a CUDA card and skips without one.  The machine with
the card has no JAX, and ``tests/conftest.py`` imports it, so run them
there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gather_cuda.py

This file imports no JAX.  A gather is a copy, so the kernel must equal
``table[idx]`` bitwise at every K and C: ragged L (C not dividing it),
L < C, rows of 1, 2, 3, 64 and 65 elements in float32, int32 and bfloat16
(rows that are not 16-byte multiples take a narrower copy word).
"""

import numpy as np
import pytest
import torch

from connectome_gnn_tpu_torch.ops import gather_dma as gd

pytestmark = pytest.mark.requires_cuda

#: (N, F, L): ragged L, L < C, L = 1, the row widths of the contract
SHAPES = [(4096, 64, 5000), (4096, 65, 3000), (1000, 3, 1025), (16384, 2, 700),
          (500, 1, 257), (300, 64, 1), (2048, 2, 4096)]
DTYPES = [torch.float32, torch.int32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def bits(t):
    """The raw bits of a 2- or 4-byte tensor, for a bitwise comparison."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def operands(N, F, L, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((N, F)).astype(np.float32) * 1000)
    table = table.to(dtype) if dtype != torch.int32 else table.to(torch.int32)
    idx = torch.from_numpy(rng.integers(0, N, L).astype(np.int32))
    return table.to(device), idx.to(device)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "int32", "bf16"])
@pytest.mark.parametrize("N,F,L", SHAPES)
def test_kernel_equals_plain_at_every_k_and_chunk(cuda, N, F, L, dtype):
    table, idx = operands(N, F, L, dtype, cuda)
    want = gd.dma_gather_reference(table, idx)
    for K in gd.K_OUTSTANDING:
        for C in (256, 1024):
            before = gd.dma_gather.launches
            got = gd.dma_gather(table, idx, k_outstanding=K, chunk=C)
            torch.cuda.synchronize()
            assert gd.dma_gather.launches == before + 1
            assert got.dtype == dtype and got.shape == (L, F)
            assert torch.equal(bits(got), bits(want)), (K, C)


def test_launch_alone_equals_plain(cuda):
    table, idx = operands(4096, 64, 5000, torch.float32, cuda)
    assert torch.equal(bits(gd._launch_gather(table, idx, 16, 512)),
                       bits(gd.dma_gather_reference(table, idx)))


def test_unaligned_table_view(cuda):
    """A table view 4 bytes into its storage: the copy word falls to 4 B."""
    flat = torch.arange(4097 * 16, dtype=torch.float32, device=cuda)
    table = flat[1 : 1 + 4096 * 16].view(4096, 16)
    idx = torch.randint(0, 4096, (3000,), dtype=torch.int32, device=cuda)
    assert gd.vector_bytes(table, torch.empty_like(table[:1])) == 4
    assert torch.equal(bits(gd.dma_gather(table, idx)), bits(table[idx.long()]))


@pytest.mark.parametrize("bad", [-1, 4096])
def test_out_of_range_index_raises_before_any_launch(cuda, bad):
    table, idx = operands(4096, 64, 2000, torch.float32, cuda)
    idx[1234] = bad
    before = gd.dma_gather.launches
    with pytest.raises(ValueError, match="outside"):
        gd.dma_gather(table, idx)
    assert gd.dma_gather.launches == before


def test_empty_index(cuda):
    table, _ = operands(100, 64, 1, torch.float32, cuda)
    out = gd.dma_gather(table, torch.zeros(0, dtype=torch.int32, device=cuda))
    assert out.shape == (0, 64) and out.device == table.device
