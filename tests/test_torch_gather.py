"""The port's random-row gather B1 (``ops/gather_dma.py``) against the kernel
function of ``benchmarks/gather_dma_experiments.py``, on the same inputs
made with numpy.

The JAX side runs its Pallas kernel on the CPU with ``interpret=True``; on
the CPU the port takes its plain version.  A gather is a copy, so the two
agree bitwise, on the script's ``--small`` cases (``:240-243``) and on
ragged ones (C not dividing L, odd row widths), with the JAX kernel on the
table as given and on its 128-lane padded form (the script's Mosaic
padding).  The kernel itself runs only on the card
(``tests/test_torch_gather_cuda.py``).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from connectome_gnn_tpu_torch.ops import gather_dma as gd

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import benchmarks.gather_dma_experiments as ge  # noqa: E402

#: (N, F, L, dtype, K, C): the script's two --small cases, then ragged ones
CASES = [
    (4096, 64, 8192, "f32", 8, 1024),
    (16384, 2, 4096, "int32", 16, 1024),
    (4096, 64, 2048, "f32", 32, 256),
    (300, 3, 77, "int32", 4, 32),
    (1000, 65, 333, "f32", 8, 100),
]


def make_case(N, F, L, dtype, seed=0):
    """The script's inputs (``run_case``, ``:157-165``)."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        table = rng.integers(0, 2**30, (N, F)).astype(np.int32)
    else:
        table = rng.standard_normal((N, F)).astype(np.float32)
    return table, rng.integers(0, N, L).astype(np.int32)


@pytest.mark.parametrize("padded", [False, True], ids=["as_given", "padded_128"])
@pytest.mark.parametrize("N,F,L,dtype,K,C", CASES)
def test_dma_gather_matches_jax_bitwise(N, F, L, dtype, K, C, padded):
    table, idx = make_case(N, F, L, dtype)
    jtable = jnp.asarray(table)
    if padded:
        jtable = jnp.pad(jtable, ((0, 0), (0, (F + 127) // 128 * 128 - F)))
    want = np.asarray(ge.dma_gather(jtable, jnp.asarray(idx), k_outstanding=K, chunk=C,
                                    interpret=True))[:, :F]
    launches = gd.dma_gather.launches
    got = gd.dma_gather(torch.from_numpy(table), torch.from_numpy(idx), k_outstanding=K, chunk=C)
    assert gd.dma_gather.launches == launches  # the CPU takes the plain version
    assert got.dtype == torch.from_numpy(table).dtype and got.shape == (L, F)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), table[idx])


@pytest.mark.parametrize("bad", [-1, 300, 2**31 - 1], ids=["negative", "N", "int32_max"])
def test_out_of_range_index_raises(bad):
    table, idx = make_case(300, 3, 77, "int32")
    idx[40] = bad
    with pytest.raises(ValueError, match="outside"):
        gd.dma_gather(torch.from_numpy(table), torch.from_numpy(idx))


@pytest.mark.parametrize("kw,match", [
    ({"k_outstanding": 5}, "k_outstanding"),
    ({"chunk": 0}, "chunk"),
    ({"chunk": gd.MAX_CHUNK + 1}, "chunk"),
], ids=["k", "chunk0", "chunk_too_big"])
def test_unbuilt_geometry_raises(kw, match):
    table, idx = make_case(300, 3, 77, "int32")
    with pytest.raises(ValueError, match=match):
        gd.dma_gather(torch.from_numpy(table), torch.from_numpy(idx), **kw)


def test_operand_checks():
    table, idx = (torch.from_numpy(a) for a in make_case(300, 3, 77, "f32"))
    with pytest.raises(ValueError, match="int32"):
        gd.dma_gather(table, idx.long())
    with pytest.raises(ValueError, match=r"\[N, F\]"):
        gd.dma_gather(table.reshape(-1), idx)
    with pytest.raises(ValueError, match="CUDA"):
        gd._launch_gather(table, idx)


def test_empty_index_and_every_dtype():
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.int8):
        table = torch.arange(60).reshape(20, 3).to(dtype)
        out = gd.dma_gather(table, torch.zeros(0, dtype=torch.int32))
        assert out.shape == (0, 3) and out.dtype == dtype
        idx = torch.tensor([19, 0, 7, 7], dtype=torch.int32)
        assert torch.equal(gd.dma_gather(table, idx), table[[19, 0, 7, 7]])


@pytest.mark.parametrize("dtype,F,want", [
    (torch.float32, 64, 16), (torch.int32, 2, 8), (torch.float32, 65, 4),
    (torch.bfloat16, 3, 2), (torch.float32, 1, 4), (torch.int8, 3, 1),
])
def test_vector_bytes(dtype, F, want):
    """The copy word the kernel is launched with: the widest of 16, 8, 4,
    2 and 1 bytes that divides a row and both base addresses."""
    table = torch.zeros((8, F), dtype=dtype)
    out = torch.zeros((4, F), dtype=dtype)
    assert table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    assert gd.vector_bytes(table, out) == want


def test_vector_bytes_follows_the_base_address():
    """16-byte rows of a table that starts 4 bytes into its storage."""
    table = torch.zeros(8 * 4 + 1)[1:].reshape(8, 4)
    assert gd.vector_bytes(torch.zeros(8, 4), torch.zeros(2, 4)) == 16
    assert gd.vector_bytes(table, torch.zeros(2, 4)) == 4
