"""The port's mixed precision (``compute_dtype=torch.bfloat16``) on the CPU
against the JAX package's ``compute_dtype=jnp.bfloat16``.

JAX rounds each dense matmul's operands to bfloat16 and sums the products
in float32 (``preferred_element_type=jnp.float32``): the products of two
bfloat16 values are exact in float32, so the result is a float32 sum of
exact products, never rounded to bfloat16.  The gates:

* the rounding bitwise ``astype(jnp.bfloat16)``'s, ties included;
* ``mixed_matmul`` within 1e-5 · Σ|a|·|b| of the float64 product of the
  rounded operands, 100× below bfloat16's output rounding, so a product
  with a bfloat16 output fails it (checked here too);
* the bf16 GCN and SAGE models at rtol / atol 1e-3 against JAX's with the
  same weights (the two sum in other orders, so one intermediate may land
  on the other side of a bfloat16 rounding: the gate allows one such
  flip), and against the port's float32 path at JAX's own gate
  (``tests/test_dense.py:95-109``: 0.05, argmax agreement ≥ 0.9);
* ``forward_auto`` of a bf16 model against JAX's
  ``forward_auto(..., interpret=True)`` at 1e-4 / 1e-5 (both serve it in
  float32 through the fused kernel's function);
* one ``Trainer`` step against JAX's (dropout 0): the loss at 1e-4, each
  gradient at 1e-2 relative Frobenius error.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import connectome_gnn_tpu as jp
import connectome_gnn_tpu_torch as tp
from connectome_gnn_tpu.ops import fused_pallas as jf
from connectome_gnn_tpu_torch.models import layers as tl
from connectome_gnn_tpu_torch.models import load_jax_params
from connectome_gnn_tpu_torch.models.compat import reference_state_dict_from_params
from connectome_gnn_tpu_torch.ops import fused as tf

CLASSES = {"gcn": (jp.GCNConnectome, tp.GCNConnectome),
           "sage": (jp.GraphSAGEConnectome, tp.GraphSAGEConnectome)}
MODEL_TOL = dict(rtol=1e-3, atol=1e-3)
FUSED_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_REL_FROB, LOSS_ATOL = 1e-2, 1e-4


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_rounding_is_jax_astype_bitwise_ties_included():
    rng = np.random.default_rng(0)
    hi = rng.integers(0, 1 << 16, 4096, dtype=np.uint32) << 16
    # low halves: exact ties (0x8000) on even and odd bfloat16 values, one
    # either side of a tie, zero, and random bits
    lows = np.array([0x8000, 0x7FFF, 0x8001, 0x0000, 0xFFFF], np.uint32)
    bits = (hi[:, None] | lows[None, :]).ravel()
    bits = np.concatenate([bits, hi | rng.integers(0, 1 << 16, 4096, dtype=np.uint32)])
    x = bits.view(np.float32)
    x = x[~np.isnan(x)]  # NaN payloads are not a rounding question
    x = np.concatenate([x, np.float32([np.inf, -np.inf, 3.3895314e38, -0.0, 1e-40])])
    got = tl.round_bf16(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()


def product_gate(a, b, got):
    """|got - (rounded a)·(rounded b) in float64| ≤ 1e-5 · Σ|a|·|b|, all
    entries; returns the worst ratio to the gate."""
    a64 = tl.round_bf16(a).double()
    b64 = tl.round_bf16(b).double()
    want = torch.matmul(a64, b64)
    scale = torch.matmul(a64.abs(), b64.abs())
    return float(((got.double() - want).abs() / (1e-5 * scale)).max())


@pytest.mark.parametrize("shape", [((300, 64), (64, 48)), ((16, 84, 84), (16, 84, 64)),
                                   ((16, 84, 5), (5, 64))])
def test_mixed_matmul_meets_the_gate_a_bf16_output_fails(shape):
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shape)
    got = tl.mixed_matmul(a, b, torch.bfloat16)
    assert got.dtype == torch.float32
    assert product_gate(a, b, got) <= 1.0
    bf16_output = torch.matmul(a.bfloat16(), b.bfloat16()).float()
    assert product_gate(a, b, bf16_output) > 1.0
    assert torch.equal(tl.mixed_matmul(a, b), torch.matmul(a, b))


@pytest.mark.parametrize("shape", [((300, 64), (64, 48)), ((16, 84, 84), (16, 84, 64)),
                                   ((16, 84, 128), (128, 64))])
def test_the_exact_products_backward_is_the_emulations_gradient(shape):
    """``_ExactProduct``'s hand-written backward (it pins the precision
    flags, which autograd's own would not) is, on the CPU, bit for bit the
    autograd gradient of the plain form (round, multiply in float32): the
    same sums, rounded to bfloat16 last by the rounding's backward."""
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_() for s in shape)
    out = tl.mixed_matmul(a, b, torch.bfloat16)
    grad = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    out.backward(grad)
    a0, b0 = (t.detach().clone().requires_grad_() for t in (a, b))
    plain = torch.matmul(tl.round_bf16(a0), tl.round_bf16(b0))
    plain.backward(grad)
    assert torch.equal(out, plain)
    for got, want in ((a.grad, a0.grad), (b.grad, b0.grad)):
        assert got.shape == want.shape and got.dtype == torch.float32
        assert torch.equal(tl.round_bf16(got), got)  # rounded to bfloat16 last
        assert torch.equal(got, want)


def test_compute_dtype_is_checked():
    with pytest.raises(ValueError, match="compute_dtype"):
        tp.GCNConnectome(in_channels=5, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="compute_dtype"):
        tl.mixed_matmul(torch.ones(2, 2), torch.ones(2, 2), torch.float16)


def test_exact_products_pins_and_restores_the_flags():
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction
    try:
        flags.allow_tf32 = flags.allow_bf16_reduced_precision_reduction = True
        with tl.exact_products():
            assert not flags.allow_tf32 and not flags.allow_bf16_reduced_precision_reduction
        assert flags.allow_tf32 and flags.allow_bf16_reduced_precision_reduction
    finally:
        flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction = saved


BATCH = dict(num_subjects=12, num_regions=30, seed=5)


@pytest.fixture(scope="module")
def batches():
    return jp.data.collate_dense(jp.generate_dataset(**BATCH)), tp.data.collate_dense(tp.generate_dataset(**BATCH))


@functools.cache
def _transplanted(kind):
    jbatch = jp.data.collate_dense(jp.generate_dataset(**BATCH))
    jcls, tcls = CLASSES[kind]
    jmodel = jcls(in_channels=5, hidden_dim=32, num_layers=3, compute_dtype=jnp.bfloat16)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    _, state = jmodel.apply(params, state, jbatch, train=True, rng=jax.random.PRNGKey(1))
    tmodel = tcls(in_channels=5, hidden_dim=32, num_layers=3, compute_dtype=torch.bfloat16)
    load_jax_params(tmodel, numpy_tree(params), numpy_tree(state))
    return jmodel, params, state, tmodel.eval()


def transplant(kind):
    """A bf16 JAX model and the port's with the same weights and non-trivial
    BatchNorm moments (one JAX train-mode pass); the port's a fresh copy."""
    jmodel, params, state, tmodel = _transplanted(kind)
    return jmodel, params, state, copy.deepcopy(tmodel)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_bf16_models_match_jax_and_the_f32_path(batches, kind):
    jbatch, tbatch = batches
    jmodel, params, state, model = transplant(kind)
    want, _ = jmodel.apply(params, state, jbatch, train=False)
    with torch.no_grad():
        got = model(tbatch)
        model.compute_dtype = torch.float32
        f32 = model(tbatch)
    assert got.dtype == torch.float32 and got.shape == (12, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    assert not torch.equal(got, f32)  # bfloat16 operands did change the numbers
    np.testing.assert_allclose(got.numpy(), f32.numpy(), rtol=0.05, atol=0.05)
    assert (got.argmax(1) == f32.argmax(1)).float().mean() >= 0.9


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_coo_layout_ignores_compute_dtype(batches, kind):
    graphs = tp.generate_dataset(num_subjects=4, num_regions=30, seed=5)
    coo = tp.collate_graphs(graphs)
    _, _, _, model = transplant(kind)
    with torch.no_grad():
        got = model(coo)
        model.compute_dtype = torch.float32
        assert torch.equal(got, model(coo))


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_forward_auto_serves_a_bf16_model_in_f32_as_jax_does(batches, kind):
    """On the card ``forward_auto`` serves a bf16 model through K1/K2,
    whose float32 function (``fused_*_forward``, the plain version on CPU
    tensors) is held here to JAX's ``forward_auto(..., interpret=True)``.
    On CPU tensors it routes a bf16 model as a float32 one, to
    ``model(batch)``; the card's launches are checked by
    ``tests/test_torch_mixed_precision_cuda.py`` and ``chip_smoke.py``."""
    jbatch, tbatch = batches
    jmodel, params, state, model = transplant(kind)
    want = jf.forward_auto(jmodel, params, state, jbatch, interpret=True)
    before = (tf.fused_gcn_kernel.launches, tf.fused_sage_kernel.launches)
    with torch.no_grad():
        fused = (tf.fused_gcn_forward if kind == "gcn" else tf.fused_sage_forward)(
            model, tbatch.node_features, tbatch.adj, tbatch.node_mask)
        assert torch.equal(tf.forward_auto(model, tbatch), model(tbatch))
    assert (tf.fused_gcn_kernel.launches, tf.fused_sage_kernel.launches) == before  # CPU: plain version
    np.testing.assert_allclose(fused.numpy(), np.asarray(want), **FUSED_TOL)


def jax_loss_grads(jmodel, params, state, batch):
    """The JAX train step's loss and its gradients (``trainer.py:176-186``)."""

    def loss_fn(p):
        logits, _ = jmodel.apply(p, state, batch, train=True, rng=jax.random.PRNGKey(0))
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, batch.labels)
        mask = batch.label_mask.astype(jnp.float32)
        return jnp.sum(ce * mask) / jnp.maximum(jnp.sum(mask), 1.0)

    return jax.jit(jax.value_and_grad(loss_fn))(params)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_one_bf16_trainer_step_matches_jax(kind):
    jcls, tcls = CLASSES[kind]
    jmodel = jcls(in_channels=5, hidden_dim=32, num_layers=2, dropout=0.0, compute_dtype=jnp.bfloat16)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    model = tcls(in_channels=5, hidden_dim=32, num_layers=2, dropout=0.0, compute_dtype=torch.bfloat16)
    load_jax_params(model, numpy_tree(params), numpy_tree(state))
    kw = dict(num_subjects=10, num_regions=20, seed=42)
    jbatch = jp.data.collate_dense(jp.generate_dataset(**kw))
    tbatch = tp.data.collate_dense(tp.generate_dataset(**kw))
    want, jgrads = jax_loss_grads(jmodel, params, state, jbatch)
    grads = reference_state_dict_from_params(numpy_tree(jgrads), numpy_tree(state), sage=kind == "sage")
    tt = tp.Trainer(model, device="cpu", prefetch_depth=0)
    got = tt.train_epoch([tbatch])
    np.testing.assert_allclose(got, float(want), rtol=0, atol=LOSS_ATOL)
    for name, p in tt.model.named_parameters():
        if kind == "gcn" and name.startswith("convs.") and name.endswith(".bias"):
            continue  # followed by BatchNorm: its gradient is float32 noise in both frameworks
        g, w = p.grad.numpy(), grads[name]
        assert np.linalg.norm(g - w) <= GRAD_REL_FROB * np.linalg.norm(w), name
