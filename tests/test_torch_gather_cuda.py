"""The random-row gather kernel B1 (``ops/gather_dma.py``,
``csrc/row_gather.cu``) against its plain PyTorch version, on the card.

Every test here needs a CUDA card and skips without one.  The machine with
the card has no JAX, and ``tests/conftest.py`` imports it, so run them
there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gather_cuda.py

This file imports no JAX.  A gather is a copy, so the kernel must equal
``table[idx]`` bitwise at every K and C: ragged L (C not dividing it),
L < C, rows of 1, 2, 3, 64 and 65 elements in float32, int32 and bfloat16.
The entry point and the launch alone are also held bitwise at rows of 8,
12, 16, 32, 256, 260, 272 and 4096 bytes, at every K and at C in (1, 7,
256, 1024, ``MAX_CHUNK``) with ragged last chunks, and on unaligned views.
The kernel checks the indices itself: an index outside the table traps in
16-B and in 4-B words, which leaves the process's CUDA context unusable, so
that case runs in a child process; and the entry point issues no host sync.
"""

import os
import subprocess
import sys

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


def launch_alone(table, idx, K=8, C=1024):
    """``table[idx]`` through the C entry alone (counts no launch)."""
    (N, F), L = table.shape, idx.numel()
    out = torch.empty((L, F), dtype=table.dtype, device=table.device)
    err = gd._entry()(table.data_ptr(), idx.data_ptr(), out.data_ptr(), L, N, F * table.element_size(),
                      gd.vector_bytes(table, out), K, C, torch.cuda.current_stream(table.device).cuda_stream)
    assert err == 0, (tuple(table.shape), K, C, err)
    return out


#: (dtype, F, word): rows of 16, 32, 256, 272 and 4096 B in 16-B words, of
#: 8 B in 8-B words, of 12 and 260 B in 4-B words
ROWS = [(torch.float32, 4, 16), (torch.float32, 8, 16), (torch.float32, 64, 16), (torch.float32, 68, 16),
        (torch.float32, 1024, 16), (torch.int32, 2, 8), (torch.int32, 3, 4), (torch.float32, 65, 4)]
#: chunks: 1, a prime, the default and MAX_CHUNK, each leaving a ragged last chunk at L = 2 * 12288 + 5
CHUNKS = [1, 7, 256, 1024, gd.MAX_CHUNK]


@pytest.mark.parametrize("dtype,F,word", ROWS, ids=[f"{F * 4}B" for _, F, _ in ROWS])
def test_row_widths_at_every_k_and_chunk(cuda, dtype, F, word):
    """The entry point and the launch alone, bitwise ``table[idx]`` at every
    K and C with a ragged last chunk, one launch counted a call."""
    table, idx = operands(3000, F, 2 * gd.MAX_CHUNK + 5, dtype, cuda, seed=F)
    want = gd.dma_gather_reference(table, idx)
    assert gd.vector_bytes(table, want) == word
    for K in gd.K_OUTSTANDING:
        for C in CHUNKS:
            assert torch.equal(bits(launch_alone(table, idx, K, C)), bits(want)), (K, C)
            before = gd.dma_gather.launches
            got = gd.dma_gather(table, idx, k_outstanding=K, chunk=C)
            assert gd.dma_gather.launches == before + 1
            assert torch.equal(bits(got), bits(want)), (K, C)
    torch.cuda.synchronize()


def test_at_the_scripts_feature_shape(cuda):
    """Case (b')'s shape (131,072 rows of 256 B from a 262,144-row table)
    and an odd L, the entry point and the launch alone, bitwise."""
    for L in (1 << 17, (1 << 17) + 333):
        table, idx = operands(262_144, 64, L, torch.float32, cuda, seed=L)
        want = gd.dma_gather_reference(table, idx)
        assert torch.equal(bits(launch_alone(table, idx)), bits(want))
        assert torch.equal(bits(gd.dma_gather(table, idx)), bits(want))


def test_unaligned_views(cuda):
    """256-B rows of a table 16 bytes into its storage keep 16-B words; 4
    bytes in, 4-B words; both bitwise."""
    flat = torch.randn(4097 * 64, device=cuda)
    idx = torch.randint(0, 4096, (5000,), dtype=torch.int32, device=cuda)
    for offset, word in ((4, 16), (1, 4)):
        table = flat[offset : offset + 4096 * 64].view(4096, 64)
        assert gd.vector_bytes(table, torch.empty_like(table[:1])) == word
        assert torch.equal(bits(gd.dma_gather(table, idx)), bits(table[idx.long()]))


#: a child that gathers with one index out of range, then synchronizes
#: (from rows of F float32, its second argument: 64 by default)
OUT_OF_RANGE_CHILD = """
import sys
import torch
from connectome_gnn_tpu_torch.ops import gather_dma as gd
table = torch.randn(4096, int(sys.argv[2]) if len(sys.argv) > 2 else 64, device="cuda")
idx = torch.randint(0, 4096, (2000,), dtype=torch.int32, device="cuda")
idx[1234] = int(sys.argv[1])
gd.dma_gather(table, idx)
torch.cuda.synchronize()
print("synchronized")
"""
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("bad", [-1, 4096])
def test_out_of_range_index_raises_before_any_launch(cuda, bad):
    """The kernel traps on an index outside [0, N) before any row is read:
    the child fails with a CUDA error by its synchronize, and this process's
    context, which never saw the bad index, still gathers."""
    table, idx = operands(4096, 64, 2000, torch.float32, cuda)
    gd.dma_gather(table, idx)  # builds the library before the child loads it
    torch.cuda.synchronize()
    child = subprocess.run([sys.executable, "-c", OUT_OF_RANGE_CHILD, str(bad)], cwd=REPO,
                           capture_output=True, text=True, timeout=600)
    assert child.returncode != 0 and "synchronized" not in child.stdout
    # the trap surfaces at the synchronize (torch's "CUDA error"), or at the
    # launch's own error check if the kernel has already stopped by then
    assert "CUDA error" in child.stderr or "kernel launch failed" in child.stderr, child.stderr[-2000:]
    assert torch.equal(bits(gd.dma_gather(table, idx)), bits(gd.dma_gather_reference(table, idx)))


@pytest.mark.parametrize("bad", [-1, 4096])
def test_out_of_range_index_traps_in_narrow_words(cuda, bad):
    """The same trap where rows of 65 float32 are copied in 4-B words."""
    table, idx = operands(4096, 65, 2000, torch.float32, cuda)
    assert gd.vector_bytes(table, table) == 4
    gd.dma_gather(table, idx)
    torch.cuda.synchronize()
    child = subprocess.run([sys.executable, "-c", OUT_OF_RANGE_CHILD, str(bad), "65"], cwd=REPO,
                           capture_output=True, text=True, timeout=600)
    assert child.returncode != 0 and "synchronized" not in child.stdout
    assert "CUDA error" in child.stderr or "kernel launch failed" in child.stderr, child.stderr[-2000:]
    assert torch.equal(bits(gd.dma_gather(table, idx)), bits(gd.dma_gather_reference(table, idx)))


def test_entry_point_issues_no_host_sync(cuda):
    """The index check runs in the kernel: under set_sync_debug_mode("error")
    any synchronizing call would raise."""
    table, idx = operands(4096, 64, 5000, torch.float32, cuda)
    want = gd.dma_gather_reference(table, idx)
    gd.dma_gather(table, idx)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [gd.dma_gather(table, idx, k_outstanding=K) for K in gd.K_OUTSTANDING]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.equal(bits(out), bits(want)) for out in outs)


def test_empty_table_raises(cuda):
    table = torch.zeros((0, 8), device=cuda)
    with pytest.raises(ValueError, match="0 rows"):
        gd.dma_gather(table, torch.zeros(3, dtype=torch.int32, device=cuda))


def test_empty_index(cuda):
    table, _ = operands(100, 64, 1, torch.float32, cuda)
    out = gd.dma_gather(table, torch.zeros(0, dtype=torch.int32, device=cuda))
    assert out.shape == (0, 64) and out.device == table.device
