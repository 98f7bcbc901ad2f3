"""K7 and the band variants B2a-B2c against their plain PyTorch versions, on
the card, and ``Trainer``'s default device.

Every test here needs a CUDA card and skips without one.  The machine with
the card has no JAX, and ``tests/conftest.py`` imports it, so run them
there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_band_variants_cuda.py

This file imports no JAX.  Tolerance: kernel against plain version rtol
1e-5 / atol 1e-5 (the same exact products, float32 sums in another order;
B2b's int32 dots are exact in both).
"""

import numpy as np
import pytest
import torch

import connectome_gnn_tpu_torch as tp
from connectome_gnn_tpu_torch.ops import band_variants as tv
from connectome_gnn_tpu_torch.ops import banded as tb
from connectome_gnn_tpu_torch.ops import banded_direct as tdir
from connectome_gnn_tpu_torch.ops import banded_quant as bq

pytestmark = pytest.mark.requires_cuda

RTOL, ATOL = 1e-5, 1e-5
#: kernel id → (kernel wrapper, entry point, plain version, band kind)
KERNELS = {
    "K7-f32": (tdir.banded_spmm_direct_kernel, tdir.banded_spmm_direct,
               tdir.banded_spmm_direct_reference, "f32"),
    "K7-bf16": (tdir.banded_spmm_direct_kernel, tdir.banded_spmm_direct,
                tdir.banded_spmm_direct_reference, "bf16"),
    "B2a": (tv.banded_spmm_bf16_kernel, tv.banded_spmm_bf16, tv.banded_spmm_bf16_reference, "bf16"),
    "B2b": (tv.banded_spmm_w8a8_kernel, tv.banded_spmm_w8a8, tv.banded_spmm_w8a8_reference, "int8"),
    "B2c": (tv.banded_spmm_quant_fused_dot_kernel, tv.banded_spmm_quant_fused_dot,
            tv.banded_spmm_quant_fused_dot_reference, "int8"),
    "B2c-wrow-bf16": (tv.banded_spmm_quant_fused_dot_kernel, tv.banded_spmm_quant_fused_dot,
                      tv.banded_spmm_quant_fused_dot_reference, "int8"),
}
#: (num_blocks, W, block, num_nodes, F): the ragged tail, W = 0, F = 5,
#: F = 1, a block of 100 with two feature slices, and a 4000-node band
SHAPES = [(10, 1, 64, 640, 16), (10, 1, 64, 600, 16), (10, 0, 64, 600, 16), (10, 2, 64, 640, 5),
          (10, 1, 64, 600, 1), (7, 1, 100, 650, 70), (16, 2, 256, 4000, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def random_band(nb, W, block, n, seed, device):
    """A random non-symmetric float32 band (70 % zeros, tile (0, 0) all
    zero), so a swapped tile axis cannot go unseen."""
    rng = np.random.default_rng(seed)
    shape = (nb, 2 * W + 1, block, block)
    band = (rng.standard_normal(shape) * (rng.random(shape) < 0.3)).astype(np.float32)
    band[0, 0] = 0
    return tb.BandedMatrix(torch.from_numpy(band).to(device), n, W)


def call(kid, fn, a, x):
    """``fn`` (kernel, entry point or plain version) on ``kid``'s operands."""
    kind = KERNELS[kid][3]
    if kind == "int8":
        q = bq.quantize_band(a)
        return fn(q, x, wrow_bf16=True) if kid == "B2c-wrow-bf16" else fn(q, x)
    band = a.band.to(torch.bfloat16) if kind == "bf16" else a.band
    if kid == "B2a":
        return fn(band, a.num_nodes, a.bandwidth, x)
    return fn(a._replace(band=band), x)


@pytest.mark.parametrize("kid", list(KERNELS))
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_version(cuda, kid, shape):
    nb, W, block, n, F = shape
    a = random_band(nb, W, block, n, seed=sum(shape), device=cuda)
    x = torch.from_numpy(np.random.default_rng(n + F).standard_normal((n, F)).astype(np.float32)).to(cuda)
    kernel, _, plain, _ = KERNELS[kid]
    before = kernel.launches
    got = call(kid, kernel, a, x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.shape == (n, F) and got.dtype == torch.float32
    torch.testing.assert_close(got, call(kid, plain, a, x), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kid", list(KERNELS))
def test_entry_points_launch_the_kernel_on_cuda_tensors(cuda, kid):
    a = random_band(10, 1, 64, 600, seed=1, device=cuda)
    x = torch.randn(600, 16, device=cuda)
    kernel, entry, _, _ = KERNELS[kid]
    before = kernel.launches
    call(kid, entry, a, x)
    assert kernel.launches == before + 1


def test_kernels_refuse_operands_they_do_not_take(cuda):
    a = random_band(10, 1, 64, 600, seed=2, device=cuda)
    x = torch.randn(600, 16, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tdir.banded_spmm_direct_kernel(a._replace(band=a.band.half()), x)
    with pytest.raises(ValueError, match="float32"):
        tdir.banded_spmm_direct_kernel(a, x.double())
    with pytest.raises(ValueError, match="unit inner stride"):
        tv.banded_spmm_quant_fused_dot_kernel(bq.quantize_band(a), x.T.contiguous().T)
    with pytest.raises(ValueError, match="share"):
        tdir.banded_spmm_direct_kernel(a._replace(band=a.band.cpu()), x)


def test_trainer_defaults_to_the_card(cuda):
    trainer = tp.Trainer(tp.GCNConnectome(in_channels=5, hidden_dim=16))
    assert trainer.device.type == "cuda"
    assert next(trainer.model.parameters()).device.type == "cuda"
