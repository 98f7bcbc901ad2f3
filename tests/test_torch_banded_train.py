"""The port's band ops for training against the JAX package, whose Pallas
kernels run with ``interpret=True``.

* ``transpose_banded``, ``transpose_quantized``, ``quantize_transposed_fm``
  and the transposed feature-major operand, ``to_blocked`` /
  ``from_blocked`` and the blocked padding are bitwise equal: the same
  copies of the same numbers.
* The plain K6 matches JAX's ``banded_spmm_quant_blocked`` at rtol 1e-5 /
  atol 1e-5, JAX's own kernel-versus-emulation gate (the same exact int8 ×
  bf16 products, float32 sums in another order), on random NON-symmetric
  bands where a swapped tile axis would show, including a ragged tail
  whose tail tiles and tail activations are non-zero: K6, like the TPU
  kernel, does not mask senders past ``num_nodes``.
* The activation gradients of the trainable wrappers match ``jax.grad`` of
  JAX's at the same gate, for the same cotangent; the float32
  ``banded_spmm`` backward matches ``jax.vjp`` of JAX's at the same gate.
* ``MaskedBatchNorm`` in the feature-major and blocked layouts matches
  ``batch_norm_apply_fm`` / ``_blocked``: outputs, running moments and
  gradients at the repository's float32 gate, rtol 1e-4 / atol 1e-5
  (moment sums in another order).

Sizes are the JAX tests': block 64, 640 nodes (600 for the ragged tail),
F = 16.  The kernels themselves run only on the card
(``tests/test_torch_banded_train_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.nn.layers as jl
import connectome_gnn_tpu.ops.banded as jb
import connectome_gnn_tpu.ops.banded_quant as jq
import connectome_gnn_tpu_torch.ops.banded as tb
import connectome_gnn_tpu_torch.ops.banded_quant as tq
from connectome_gnn_tpu_torch.nn.layers import MaskedBatchNorm

RTOL, ATOL = 1e-5, 1e-5
F32_RTOL, F32_ATOL = 1e-4, 1e-5
F = 16

#: case → (nb, W, num_nodes) of a random band; None for the spatial graph
CASES = {
    "spatial-640": None,
    "nonsymmetric-ragged-600": (10, 1, 600),
    "nonsymmetric-W0": (10, 0, 600),
    "nonsymmetric-W2": (10, 2, 640),
}


def random_int8_band(nb, W, block, seed):
    """Random non-symmetric int8 tiles (70 % zeros, tile (0, 0) all zero
    with scale 1) and per-tile scales, as numpy; the tail tiles are
    non-zero too."""
    rng = np.random.default_rng(seed)
    shape = (nb, 2 * W + 1, block, block)
    q = (rng.integers(-127, 128, shape) * (rng.random(shape) < 0.3)).astype(np.int8)
    scales = rng.uniform(1e-3, 1.1e-2, shape[:2]).astype(np.float32)
    q[0, 0], scales[0, 0] = 0, 1.0
    return q, scales


def spatial_band(n=640):
    g = jd.generate_spatial_graph(n, degree=6, band=40, num_features=F, seed=2)
    return jb.to_banded(g.edge_index[0], g.edge_index[1], g.edge_weight, n, block=64)


@pytest.fixture(scope="module")
def int8_bands():
    """case → (JAX QuantizedBandedMatrix, port QuantizedBandedMatrix)."""
    out = {}
    for case, spec in CASES.items():
        if spec is None:
            jqq = jq.quantize_band(jb.gcn_normalize_banded(spatial_band())[0])
            q, s, n, W = np.array(jqq.band_q), np.array(jqq.scales), jqq.num_nodes, jqq.bandwidth
        else:
            nb, W, n = spec
            q, s = random_int8_band(nb, W, 64, seed=nb + W + n)
            jqq = jq.QuantizedBandedMatrix(jnp.asarray(q), jnp.asarray(s), n, W)
        out[case] = (jqq, tq.QuantizedBandedMatrix(torch.from_numpy(q), torch.from_numpy(s), n, W))
    return out


@pytest.fixture(scope="module")
def trainable(int8_bands):
    """case → (JAX q, qT, port q, qT), the feature-major forward operand
    and its transpose, each built by its own package."""
    out = {}
    for case, (jqq, tqq) in int8_bands.items():
        out[case] = (jq.to_feature_major(jqq), jq.to_feature_major(jq.transpose_quantized(jqq)),
                     tq.to_feature_major(tqq), tq.transposed_feature_major(tqq))
    return out


def assert_same_band(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("case", list(CASES))
def test_transpose_banded_is_bitwise_equal(case):
    if CASES[case] is None:
        ja = spatial_band()
        band = np.array(ja.band)
    else:
        nb, W, n = CASES[case]
        rng = np.random.default_rng(nb + W + n)
        shape = (nb, 2 * W + 1, 64, 64)
        band = (rng.standard_normal(shape) * (rng.random(shape) < 0.3)).astype(np.float32)
        ja = jb.BandedMatrix(jnp.asarray(band), n, W)
    ta = tb.BandedMatrix(torch.from_numpy(band), ja.num_nodes, ja.bandwidth)
    got, want = tb.transpose_banded(ta), jb.transpose_banded(ja)
    assert_same_band(got.band, want.band)
    assert (got.num_nodes, got.bandwidth) == (want.num_nodes, want.bandwidth)
    if CASES[case] is None:  # a real band has no tiles off its edges, so Aᵀᵀ = A
        assert torch.equal(tb.transpose_banded(got).band, ta.band)


@pytest.mark.parametrize("case", list(CASES))
def test_transpose_quantized_and_its_feature_major_form_are_bitwise_equal(int8_bands, trainable, case):
    jqq, tqq = int8_bands[case]
    got, want = tq.transpose_quantized(tqq), jq.transpose_quantized(jqq)
    assert_same_band(got.band_q, want.band_q)
    assert_same_band(got.scales, want.scales)
    jqT, tqT = trainable[case][1], trainable[case][3]
    # the shifted copy without tile transposes equals the two-step route
    assert_same_band(tqT.band_qT, jqT.band_qT)
    assert_same_band(tqT.scales, jqT.scales)
    assert torch.equal(tqT.band_qT, tq.to_feature_major(got).band_qT)
    assert (tqT.num_nodes, tqT.bandwidth) == (jqT.num_nodes, jqT.bandwidth)


def test_quantize_transposed_fm_is_bitwise_equal():
    jn = jb.gcn_normalize_banded(spatial_band(600))[0]
    tn = tb.BandedMatrix(torch.from_numpy(np.array(jn.band)), 600, jn.bandwidth)
    got, want = tq.quantize_transposed_fm(tn), jq.quantize_transposed_fm(jn)
    assert_same_band(got.band_qT, want.band_qT)
    assert_same_band(got.scales, want.scales)
    assert bool((got.scales[-1, -1] == 1.0).all())  # a shifted-in zero tile


def test_blocked_layout_round_trip_and_padding():
    xT_pad = np.random.default_rng(0).standard_normal((5, 10 * 64)).astype(np.float32)
    xb = tq.to_blocked(torch.from_numpy(xT_pad), 64)
    assert xb.shape == (10, 5, 64) and xb.is_contiguous()
    assert_same_band(xb, jq.to_blocked(jnp.asarray(xT_pad), 64))
    assert_same_band(tq.from_blocked(xb), jq.from_blocked(jq.to_blocked(jnp.asarray(xT_pad), 64)))
    assert torch.equal(tq.from_blocked(xb), torch.from_numpy(xT_pad))
    for W in (0, 2):
        assert_same_band(tq._pad_blocked(xb, W), jq._pad_blocked(jnp.asarray(xb.numpy()), W))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k6_matches_jax_interpret(trainable, case):
    jqf, _, tqf, _ = trainable[case]
    nb, W = tqf.num_blocks, tqf.bandwidth
    # the whole padded frame random, halo and tail included
    xb_pad = np.random.default_rng(nb + W).standard_normal((nb + 2 * W, F, 64)).astype(np.float32)
    got = tq.banded_spmm_quant_blocked_reference(tqf, torch.from_numpy(xb_pad))
    want = np.asarray(jq.banded_spmm_quant_blocked(jqf, jnp.asarray(xb_pad), interpret=True))
    assert got.shape == (nb, F, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(tq.banded_spmm_quant_blocked(tqf, torch.from_numpy(xb_pad)), got)


def test_k6_reads_senders_past_num_nodes(trainable):
    """Unlike K4, K6 does not mask the tail: non-zero tail activations move
    the output of real nodes through the non-zero tail tiles."""
    _, _, tqf, _ = trainable["nonsymmetric-ragged-600"]
    nb, W = tqf.num_blocks, tqf.bandwidth
    xb_pad = torch.zeros((nb + 2 * W, F, 64))
    xb_pad[W + nb - 1, :, 600 - 9 * 64 :] = 1.0  # senders 600..639 only
    out = tq.banded_spmm_quant_blocked_reference(tqf, xb_pad)
    assert float(out[: nb - 1].abs().max()) > 0


def test_k6_refuses_a_frame_of_the_wrong_shape(trainable):
    _, _, tqf, _ = trainable["nonsymmetric-W2"]
    with pytest.raises(ValueError, match="activations must be"):
        tq.banded_spmm_quant_blocked_reference(tqf, torch.zeros((tqf.num_blocks, F, 64)))


def cotangent(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_fm_grad_forward_and_gradient_match_jax(trainable, case):
    jqf, jqT, tqf, tqT = trainable[case]
    n = tqf.num_nodes
    xT, cot = cotangent((F, n), 1), cotangent((F, n), 2)

    want_out, vjp = jax.vjp(lambda v: jq.banded_spmm_quant_fm_grad(jqf, jqT, v, interpret=True),
                            jnp.asarray(xT))
    (want_grad,) = vjp(jnp.asarray(cot))
    v = torch.from_numpy(xT).requires_grad_()
    out = tq.banded_spmm_quant_fm_grad(tqf, tqT, v)
    (out * torch.from_numpy(cot)).sum().backward()
    assert torch.equal(out.detach(), tq.banded_spmm_quant_fm_reference(tqf, v.detach()))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=ATOL)
    assert tqf.band_qT.grad is None and not tqf.band_qT.requires_grad


def test_fm_grad_gives_columns_past_num_nodes_zero_gradient(trainable):
    """K4 reads ``xT [F, ≥num_nodes]``; the columns past ``num_nodes`` never
    enter the forward, so their gradient is zero, as in the float32
    backward (``connectome_gnn_tpu/ops/banded.py:198-204``)."""
    _, _, tqf, tqT = trainable["nonsymmetric-ragged-600"]
    wide = torch.from_numpy(cotangent((F, 640), 9)).requires_grad_()
    narrow = wide.detach()[:, :600].clone().requires_grad_()
    cot = torch.from_numpy(cotangent((F, 600), 10))
    for v in (wide, narrow):
        (tq.banded_spmm_quant_fm_grad(tqf, tqT, v) * cot).sum().backward()
    assert torch.equal(wide.grad[:, :600], narrow.grad)
    assert bool((wide.grad[:, 600:] == 0).all())


@pytest.mark.parametrize("case", list(CASES))
def test_blocked_grad_forward_and_gradient_match_jax(trainable, case):
    jqf, jqT, tqf, tqT = trainable[case]
    nb = tqf.num_blocks
    xb, cot = cotangent((nb, F, 64), 3), cotangent((nb, F, 64), 4)

    def loss(v):
        return jnp.sum(jq.banded_spmm_quant_blocked_grad(jqf, jqT, v, interpret=True) * cot)

    want_loss, want_grad = jax.value_and_grad(loss)(jnp.asarray(xb))
    v = torch.from_numpy(xb).requires_grad_()
    got_loss = (tq.banded_spmm_quant_blocked_grad(tqf, tqT, v) * torch.from_numpy(cot)).sum()
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=ATOL)


def test_blocked_grad_matches_fm_grad(trainable):
    """JAX's own gate between its blocked and feature-major trainable
    paths (tests/test_banded_quant.py:643-690): loss 1e-5, gradient 1e-5.
    Real nodes only: the padded tail holds zeros and zero cotangent."""
    _, _, tqf, tqT = trainable["spatial-640"]
    nb, n = tqf.num_blocks, tqf.num_nodes
    xb = torch.from_numpy(cotangent((nb, F, 64), 5)).requires_grad_()
    cot = torch.from_numpy(cotangent((nb, F, 64), 6))
    (tq.banded_spmm_quant_blocked_grad(tqf, tqT, xb) * cot).sum().backward()
    xT = tq.from_blocked(xb.detach())[:, :n].clone().requires_grad_()
    (tq.banded_spmm_quant_fm_grad(tqf, tqT, xT) * tq.from_blocked(cot)[:, :n]).sum().backward()
    np.testing.assert_allclose(tq.from_blocked(xb.grad)[:, :n].numpy(), xT.grad.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_trainable_wrappers_refuse_mismatched_operands(trainable):
    _, _, tqf, tqT = trainable["nonsymmetric-W2"]
    other = tqT._replace(num_nodes=600)
    with pytest.raises(ValueError, match="disagree"):
        tq.banded_spmm_quant_fm_grad(tqf, other, torch.zeros((F, 640)))
    with pytest.raises(ValueError, match="disagree"):
        tq.banded_spmm_quant_blocked_grad(tqf, other, torch.zeros((10, F, 64)))


def test_entry_points_take_the_plain_version_on_cpu(trainable):
    _, _, tqf, tqT = trainable["nonsymmetric-ragged-600"]
    kernels = (tq.banded_spmm_quant_fm_kernel, tq.banded_spmm_quant_fm_grad_kernel,
               tq.banded_spmm_quant_blocked_kernel)
    before = [k.launches for k in kernels]
    xT = torch.randn(F, 600, requires_grad=True)
    tq.banded_spmm_quant_fm_grad(tqf, tqT, xT).sum().backward()
    xb = torch.randn(10, F, 64, requires_grad=True)
    tq.banded_spmm_quant_blocked_grad(tqf, tqT, xb).sum().backward()
    assert [k.launches for k in kernels] == before


@pytest.mark.parametrize("kernel", ["banded_spmm_quant_blocked_kernel", "banded_spmm_quant_fm_grad_kernel"])
def test_kernel_wrappers_refuse_cpu_tensors(trainable, kernel):
    _, _, tqf, _ = trainable["nonsymmetric-W2"]
    fn = getattr(tq, kernel)
    x = torch.zeros((14, F, 64)) if kernel == "banded_spmm_quant_blocked_kernel" else torch.zeros((F, 640))
    before = fn.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fn(tqf, x)
    assert fn.launches == before


@pytest.mark.parametrize("x_rows", [600, 640])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_f32_banded_spmm_backward_matches_jax_vjp(x_rows, dtype):
    ja = spatial_band(600)
    ja = ja._replace(band=ja.band.astype(getattr(jnp, dtype)))
    ta = tb.BandedMatrix(torch.from_numpy(np.array(ja.band.astype(jnp.float32))).to(getattr(torch, dtype)),
                         600, ja.bandwidth)
    x, g = cotangent((x_rows, F), 7), cotangent((600, F), 8)
    want_out, vjp = jax.vjp(lambda v: jb.banded_spmm(ja, v), jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(g))
    v = torch.from_numpy(x).requires_grad_()
    out = tb.banded_spmm(ta, v)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=ATOL)
    assert bool((v.grad[600:] == 0).all())


def test_f32_banded_spmm_backward_is_the_transpose():
    """x̄ = Aᵀ·ȳ: the backward equals the forward over transpose_banded."""
    ta = tb.BandedMatrix(torch.from_numpy(np.array(spatial_band(600).band)), 600, 1)
    v = torch.randn(600, F, requires_grad=True)
    g = torch.randn(600, F)
    tb.banded_spmm(ta, v).backward(g)
    torch.testing.assert_close(v.grad, tb.banded_spmm(tb.transpose_banded(ta), g), rtol=RTOL, atol=ATOL)


def batch_norm_operands(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, F).astype(np.float32),
              "bias": rng.normal(0.0, 0.2, F).astype(np.float32)}
    state = {"mean": rng.normal(0.0, 0.5, F).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, F).astype(np.float32)}
    return x, params, state, cotangent(shape, seed + 1)


def port_batch_norm(params, state, train):
    bn = MaskedBatchNorm(F)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(state["mean"]))
        bn.running_var.copy_(torch.from_numpy(state["var"]))
    return bn.train(train)


#: layout → (activation shape, mask shape, JAX function, port method)
BN_LAYOUTS = {
    "fm": ((F, 600), (600,), jl.batch_norm_apply_fm, "forward_fm"),
    "blocked": ((10, F, 64), (10, 64), jl.batch_norm_apply_blocked, "forward_blocked"),
}


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("layout", list(BN_LAYOUTS))
def test_batch_norm_layouts_match_jax(layout, train, masked):
    shape, mask_shape, jax_fn, method = BN_LAYOUTS[layout]
    x, params, state, cot = batch_norm_operands(shape, seed=len(shape))
    mask = (np.random.default_rng(9).random(mask_shape) < 0.9) if masked else None

    def f(v, scale, bias):
        jmask = None if mask is None else jnp.asarray(mask)
        return jax_fn({"scale": scale, "bias": bias}, state, v, jmask, train=train)

    primals = (jnp.asarray(x), jnp.asarray(params["scale"]), jnp.asarray(params["bias"]))
    want, vjp, new_state = jax.vjp(f, *primals, has_aux=True)
    gx, gscale, gbias = vjp(jnp.asarray(cot))
    bn = port_batch_norm(params, state, train)
    v = torch.from_numpy(x).requires_grad_()
    got = getattr(bn, method)(v, None if mask is None else torch.from_numpy(mask))
    got.backward(torch.from_numpy(cot))
    for a, b in ((got.detach(), want), (v.grad, gx), (bn.weight.grad, gscale), (bn.bias.grad, gbias),
                 (bn.running_mean, new_state["mean"]), (bn.running_var, new_state["var"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=F32_RTOL, atol=F32_ATOL)
    assert int(bn.num_batches_tracked) == int(train)


def test_batch_norm_layouts_agree_with_the_node_major_one():
    x, params, state, _ = batch_norm_operands((10, F, 64), seed=4)
    mask_b = np.random.default_rng(9).random((10, 64)) < 0.9
    xb, mb = torch.from_numpy(x), torch.from_numpy(mask_b)
    node_major = xb.transpose(1, 2).reshape(640, F)
    bns = [port_batch_norm(params, state, True) for _ in range(3)]
    outs = [bns[0].forward_blocked(xb, mb).transpose(1, 2).reshape(640, F),
            bns[1].forward_fm(node_major.T, mb.reshape(-1)).T,
            bns[2](node_major, mb.reshape(-1))]
    for out, bn in zip(outs[1:], bns[1:]):
        torch.testing.assert_close(out, outs[0], rtol=F32_RTOL, atol=F32_ATOL)
        torch.testing.assert_close(bn.running_var, bns[0].running_var, rtol=F32_RTOL, atol=F32_ATOL)
