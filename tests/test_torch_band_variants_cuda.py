"""K7 and the band variants B2a-B2c against their plain PyTorch versions, on
the card, and ``Trainer``'s default device.

Every test here needs a CUDA card and skips without one.  The machine with
the card has no JAX, and ``tests/conftest.py`` imports it, so run them
there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_band_variants_cuda.py

This file imports no JAX.  Tolerance: kernel against plain version rtol
1e-5 / atol 1e-5 (the same exact products, float32 sums in another order),
except B2b, held bit for bit (``torch.equal``): its int32 dots are exact,
then exact in float32, and the kernel rounds the scale's product and the
sum apart in the plain version's order, at every shape here and at blocks
of 16, 40 and 48 with F = 1, 5 and 130.  K7 over a float32 band and B2c
without ``wrow_bf16`` run on the tensor cores in an order of sums the plain
version's float32 sums cannot share, and at the 4000-node shape those sums
are themselves more than 1e-5 from the exact value of their function (by
cancellation; ``tests/test_torch_band_mma.py`` records it on the CPU, whose
bits the card's plain version repeats).  So those two are held at the same
1e-5 to their plain version summed in float64 (``sum_dtype``: the same
operands and products, no float32 rounding of the sums), and to the
float32 plain version within 1e-5 of the sum of the products' magnitudes.
The six-decade cases spread the band or the scales and ``x`` over three
decades each way and hold each output within 1e-5 of that magnitude sum.
"""

import numpy as np
import pytest
import torch

import connectome_gnn_tpu_torch as tp
from connectome_gnn_tpu_torch.ops import band_mma
from connectome_gnn_tpu_torch.ops import band_variants as tv
from connectome_gnn_tpu_torch.ops import banded as tb
from connectome_gnn_tpu_torch.ops import banded_direct as tdir
from connectome_gnn_tpu_torch.ops import banded_quant as bq

pytestmark = pytest.mark.requires_cuda

RTOL, ATOL = 1e-5, 1e-5
#: |kernel - plain| against the sum of the products' magnitudes
MAGNITUDE_RTOL = 1e-5
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
#: the kernels held at 1e-5 to their plain version's float64 sums
FLOAT64_SUMS = ("K7-f32", "B2c")
#: the kernels held to their plain version bit for bit
EXACT = ("B2b",)
#: the C entry point each tensor-core wrapper launches, and its last flag
ENTRY_POINTS = {"K7-f32": ("cgt_banded_spmm_direct_f32", None),
                "B2b": ("cgt_banded_spmm_w8a8_rowmajor", None),
                "B2c": ("cgt_banded_spmm_quant_fused_dot", 0),
                "B2c-wrow-bf16": ("cgt_banded_spmm_quant_fused_dot", 1)}
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


def call(kid, fn, a, x, q=None, **kw):
    """``fn`` (kernel, entry point or plain version) on ``kid``'s operands:
    the int8 band ``q`` where given, else ``a`` quantized."""
    kind = KERNELS[kid][3]
    if kind == "int8":
        q = bq.quantize_band(a) if q is None else q
        return fn(q, x, wrow_bf16=True, **kw) if kid == "B2c-wrow-bf16" else fn(q, x, **kw)
    band = a.band.to(torch.bfloat16) if kind == "bf16" else a.band
    if kid == "B2a":
        return fn(band, a.num_nodes, a.bandwidth, x)
    return fn(a._replace(band=band), x, **kw)


def magnitude(kid, a, x, q=None):
    """The plain version over the magnitudes of the operands: each output's
    sum of its products' magnitudes."""
    plain = KERNELS[kid][2]
    if KERNELS[kid][3] == "int8":
        q = bq.quantize_band(a) if q is None else q
        return call(kid, plain, a, x.abs(), q=q._replace(band_q=q.band_q.abs(), scales=q.scales.abs()))
    return call(kid, plain, a._replace(band=a.band.abs()), x.abs())


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
    want = call(kid, plain, a, x)
    if kid in EXACT:
        assert torch.equal(got, want)
        return
    if kid in FLOAT64_SUMS:
        assert bool(((got - want).abs() <= MAGNITUDE_RTOL * magnitude(kid, a, x)).all())
        want = call(kid, plain, a, x, sum_dtype=torch.float64)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("F", [1, 5, 130])
@pytest.mark.parametrize("W", [0, 1, 2])
@pytest.mark.parametrize("block", [16, 40, 48])
def test_b2b_is_its_plain_version_bit_for_bit_at_ragged_shapes(cuda, block, W, F):
    """Blocks of 16 and 48 (one partial 128-sender chunk, its zero fill
    from TMA) and 40 (padded to 48), one, a partial and three 64-feature
    units, a partial last row block."""
    nb = 6
    n = nb * block - 5
    a = random_band(nb, W, block, n, seed=block + 10 * W + F, device=cuda)
    x = torch.from_numpy(np.random.default_rng(F).standard_normal((n, F)).astype(np.float32)).to(cuda)
    q = bq.quantize_band(a)
    got = tv.banded_spmm_w8a8_kernel(q, x)
    assert got.shape == (n, F)
    assert torch.equal(got, tv.banded_spmm_w8a8_reference(q, x))


def test_b2b_launch_alone_equals_the_wrapper_and_the_saturated_dot(cuda):
    """At the main shape's layout (b = 256, F = 64) B2b's wrapper hands the
    kernel the band as it is and the int8 frame it builds; the launch alone
    on them gives the wrapper's output.  Band and x of ±127, one tile all
    +127 against a frame block all +127 (a dot of 127²·256): bit for bit
    the plain version."""
    nb, W, b, F = 6, 2, 256, 64
    n = nb * b - 37
    rng = np.random.default_rng(12)
    band = (127 * rng.choice([-1, 1], (nb, 2 * W + 1, b, b))).astype(np.int8)
    band[2, W] = 127
    scales = rng.uniform(1e-3, 1.1e-2, (nb, 2 * W + 1)).astype(np.float32)
    q = bq.QuantizedBandedMatrix(torch.from_numpy(band).to(cuda), torch.from_numpy(scales).to(cuda), n, W)
    x = torch.from_numpy(rng.choice([-3.0, 3.0], (n, F)).astype(np.float32)).to(cuda)
    x[2 * b:3 * b] = 3.0  # frame block 2 + W, which tile (2, W) reads
    xq_p, xs = tv.w8a8_operands(q, x)
    assert band_mma.pad_band(q.band_q) is q.band_q and xq_p.shape == (F, (nb + 2 * W) * b)
    assert int(xq_p[:, W * b:(W + nb) * b - 37].abs().min()) == 127
    alone = band_mma.launch_rowmajor_w8a8("B2b", q.band_q, q.scales, xq_p, xs, n, W, b)
    got = tv.banded_spmm_w8a8_kernel(q, x)
    assert torch.equal(alone, got)
    assert torch.equal(got, tv.banded_spmm_w8a8_reference(q, x))


@pytest.mark.parametrize("kid", list(ENTRY_POINTS))
@pytest.mark.parametrize("shape", [(20, 2, 256, 5000, 64), (7, 1, 100, 650, 70)])
def test_accumulation_over_six_decades(cuda, kid, shape):
    """K7's float32 band and x, or B2c's scales and x, spread log-uniformly
    over three decades each way: each output within 1e-5 of the sum of its
    products' magnitudes."""
    nb, W, block, n, F = shape
    a = random_band(nb, W, block, n, seed=sum(shape), device=cuda)
    rng = np.random.default_rng(n + F)
    x = rng.standard_normal((n, F)) * 10.0 ** rng.uniform(-3, 3, (n, F))
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    q = None
    if kid == "K7-f32":
        spread = 10.0 ** rng.uniform(-3, 3, tuple(a.band.shape))
        a = a._replace(band=a.band * torch.from_numpy(spread.astype(np.float32)).to(cuda))
    else:
        q = bq.quantize_band(a)
        scales = 10.0 ** rng.uniform(-3, 3, tuple(q.scales.shape))
        q = q._replace(scales=torch.from_numpy(scales.astype(np.float32)).to(cuda))
    kernel, _, plain, _ = KERNELS[kid]
    got = call(kid, kernel, a, x, q=q)
    want = call(kid, plain, a, x, q=q)
    assert bool(((got - want).abs() <= MAGNITUDE_RTOL * magnitude(kid, a, x, q)).all())


@pytest.mark.parametrize("kid", list(ENTRY_POINTS))
def test_launches_go_through_the_tensor_core_body(cuda, kid, monkeypatch):
    """The wrapper launches the C entry point of ``csrc/band_mma.cu``
    (``tests/test_torch_band_mma.py`` holds that it is defined there and
    nowhere else), with B2c's ``wrow_bf16`` flag."""
    seen, launch = [], band_mma._launch
    monkeypatch.setattr(band_mma, "_launch",
                        lambda kind, entry, *args: (seen.append((entry, args)), launch(kind, entry, *args)))
    a = random_band(10, 1, 64, 600, seed=4, device=cuda)
    call(kid, KERNELS[kid][0], a, torch.randn(600, 16, device=cuda))
    entry, flag = ENTRY_POINTS[kid]
    assert [e for e, _ in seen] == [entry]
    if flag is not None:
        assert seen[0][1][-2] == flag


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
