"""Int8-band training of the port's BandedNodeGCN against the JAX package's,
with JAX's weights carried over by ``load_jax_params``.

JAX initializes; the BatchNorm affine and running moments are drawn from
numpy.  One train step's mean cross-entropy and every parameter gradient,
through ``apply_quant_trainable`` (K4 both ways) and
``apply_quant_trainable_blocked`` (K6 both ways), match
``jax.value_and_grad`` of JAX's with its kernels in interpret mode, and so
do the running moments after the step:

* loss at rtol 1e-5: one float32 mean of per-node terms that agree to a
  few ulps;
* gradients and moments at rtol 1e-4 / atol 1e-5, the repository's
  float32 gate, looser than the 1e-5 of the layer-level tests
  (``tests/test_torch_banded_train.py``).  The kernels round each layer's
  input to bf16, and a float32 summation-order difference upstream (the
  weight matmul, the BatchNorm moments) moves a value that lies within
  float32 noise of a rounding boundary by 2^-8 of itself; through two
  layers and their backward that reaches ~1e-5 relative in a gradient.
  The same trap as serving (``tests/test_torch_node_models.py``).

Within the port, blocked matches feature-major at JAX's own gate
(``tests/test_banded_quant.py:715-725``): loss 1e-5, gradients rtol 1e-4,
with atol 1e-5 where JAX has 1e-6.  The two layouts sum the BatchNorm
moments and their backward in another order, and the bf16 rounding of the
cotangent inside the kernels turns that into conv-weight gradients apart
by up to 1.5e-6 (1.2e-4 of the largest); with float32 activations in both
kernels' plain versions the gap is 2.4e-8.  The
8-step Adam run of the int8 path tracks the port's float32 path within
0.05 of loss (``tests/test_banded_quant.py:557-601``, torch only).

Sizes are the JAX tests': 640 nodes, block 64, F 16, hidden 16, 2 layers;
the Adam run 320 nodes, block 32.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.models as jm
import connectome_gnn_tpu.ops.banded as jb
import connectome_gnn_tpu_torch as tp
import connectome_gnn_tpu_torch.ops.banded as tb
import connectome_gnn_tpu_torch.ops.banded_quant as tq
from connectome_gnn_tpu_torch.models import load_jax_params
from connectome_gnn_tpu_torch.models.compat import reference_state_dict_from_params

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
#: the JAX package's blocked-versus-feature-major gate, atol as GRAD_ATOL
BLOCKED_LOSS_RTOL, BLOCKED_GRAD_RTOL, BLOCKED_GRAD_ATOL = 1e-5, 1e-4, 1e-5
N, FEAT, HIDDEN = 640, 16, 16
#: path → (JAX method, port method, node mask)
PATHS = {
    "fm": ("apply_quant_trainable", "apply_quant_trainable", False),
    "fm-masked": ("apply_quant_trainable", "apply_quant_trainable", True),
    "blocked": ("apply_quant_trainable_blocked", "apply_quant_trainable_blocked", False),
}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def spatial(n, block, seed=2):
    g = jd.generate_spatial_graph(n, degree=6, band=40, num_features=FEAT, seed=seed)
    coo = (g.edge_index[0], g.edge_index[1], g.edge_weight, n)
    return jb.to_banded(*coo, block=block), tb.to_banded(*coo, block=block), g.node_features


@pytest.fixture(scope="module")
def setup():
    """JAX model, params, state and prepared band; the port's model (train
    mode) and prepared band; features, labels and a node mask."""
    ja, ta, x = spatial(N, 64)
    rng = np.random.default_rng(0)
    jmodel = jm.BandedNodeGCN(in_channels=FEAT, hidden_dim=HIDDEN, num_layers=2)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    params["norms"] = [
        {"scale": jnp.asarray(rng.uniform(0.5, 1.5, HIDDEN), jnp.float32),
         "bias": jnp.asarray(rng.normal(0.0, 0.2, HIDDEN), jnp.float32)}
        for _ in params["norms"]
    ]
    state = {"norms": [
        {"mean": jnp.asarray(rng.normal(0.0, 0.5, HIDDEN), jnp.float32),
         "var": jnp.asarray(rng.uniform(0.5, 2.0, HIDDEN), jnp.float32)}
        for _ in state["norms"]
    ]}
    tmodel = tp.BandedNodeGCN(in_channels=FEAT, hidden_dim=HIDDEN, num_layers=2)
    load_jax_params(tmodel, numpy_tree(params), numpy_tree(state))
    labels = np.random.default_rng(4).integers(0, 2, N)
    mask = np.random.default_rng(5).random(N) < 0.9
    return dict(
        jmodel=jmodel, params=params, state=state, jprep=jmodel.prepare_quant_trainable(ja),
        tmodel=tmodel.train(), tprep=tmodel.prepare_quant_trainable(ta), x=x, labels=labels,
        mask=mask,
    )


def port_step(setup, method, *, mask=None, x=None, model=None):
    """One forward and backward of a copy of the port's model; returns
    (loss, {name: gradient}, model)."""
    model = model or copy.deepcopy(setup["tmodel"])
    x = torch.from_numpy(setup["x"]) if x is None else x
    node_mask = None if mask is None else torch.from_numpy(mask)
    logits = getattr(model, method)(*setup["tprep"], x, node_mask=node_mask)
    loss = F.cross_entropy(logits, torch.from_numpy(setup["labels"]))
    loss.backward()
    return loss.item(), {k: p.grad for k, p in model.named_parameters()}, model


@pytest.fixture(scope="module")
def jax_steps(setup):
    """path → (loss, reference state_dict of the gradients and the new
    running moments), from ``jax.value_and_grad`` in interpret mode."""
    out = {}
    labels = jnp.asarray(setup["labels"], jnp.int32)
    for path, (jmethod, _, masked) in PATHS.items():
        fn = getattr(setup["jmodel"], jmethod)
        mask = jnp.asarray(setup["mask"]) if masked else None

        def loss_fn(p, fn=fn, mask=mask):
            logits, new_state = fn(p, setup["state"], *setup["jprep"], jnp.asarray(setup["x"]),
                                   node_mask=mask, train=True, interpret=True)
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
            return jnp.mean(ce), new_state

        (loss, new_state), grads = jax.value_and_grad(loss_fn, has_aux=True)(setup["params"])
        out[path] = float(loss), reference_state_dict_from_params(
            numpy_tree(grads), numpy_tree(new_state), sage=False)
    return out


def test_prepare_quant_trainable_matches_jax(setup):
    """The int8 tiles are bitwise equal; the scales within 1e-6, since each
    package normalizes the band with sums in its own order (given the same
    normalized band they are bitwise equal, ``test_torch_banded_train.py``)."""
    (jqf, jqT, jdinv), (tqf, tqT, tdinv) = setup["jprep"], setup["tprep"]
    np.testing.assert_allclose(tdinv.numpy(), np.asarray(jdinv), rtol=1e-6, atol=1e-6)
    for t, j in ((tqf, jqf), (tqT, jqT)):
        np.testing.assert_array_equal(t.band_qT.numpy(), np.asarray(j.band_qT))
        np.testing.assert_allclose(t.scales.numpy(), np.asarray(j.scales), rtol=1e-6, atol=0)
        assert (t.num_nodes, t.bandwidth) == (j.num_nodes, j.bandwidth)


def test_prepare_quant_trainable_refuses_a_hybrid(setup):
    g = tp.generate_spatial_graph(640, degree=6, band=40, seed=3, shortcut_frac=0.15)
    h = tb.to_hybrid(g.edge_index[0], g.edge_index[1], g.edge_weight, 640, block=64, bandwidth=1)
    with pytest.raises(ValueError, match="pure bands"):
        setup["tmodel"].prepare_quant_trainable(h)


@pytest.mark.parametrize("path", list(PATHS))
def test_train_step_matches_jax_value_and_grad(setup, jax_steps, path):
    _, method, masked = PATHS[path]
    want_loss, want = jax_steps[path]
    loss, grads, model = port_step(setup, method, mask=setup["mask"] if masked else None)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    assert set(grads) <= set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
    for i, bn in enumerate(model.batch_norms):
        for buf in ("running_mean", "running_var"):
            np.testing.assert_allclose(getattr(bn, buf).numpy(), want[f"batch_norms.{i}.{buf}"],
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)
            assert not torch.equal(getattr(bn, buf), getattr(setup["tmodel"].batch_norms[i], buf))
        assert int(bn.num_batches_tracked) == 1


def test_blocked_matches_feature_major_within_the_port(setup):
    loss_fm, grads_fm, model_fm = port_step(setup, "apply_quant_trainable")
    loss_b, grads_b, model_b = port_step(setup, "apply_quant_trainable_blocked")
    np.testing.assert_allclose(loss_b, loss_fm, rtol=BLOCKED_LOSS_RTOL)
    for name in grads_fm:
        torch.testing.assert_close(grads_b[name], grads_fm[name], rtol=BLOCKED_GRAD_RTOL,
                                   atol=BLOCKED_GRAD_ATOL, msg=name)
    for a, b in zip(model_b.buffers(), model_fm.buffers()):
        torch.testing.assert_close(a, b, rtol=BLOCKED_GRAD_RTOL, atol=BLOCKED_GRAD_ATOL)


def test_blocked_takes_pre_blocked_input(setup):
    x = torch.from_numpy(setup["x"])
    xb = tq.to_blocked(x.T.contiguous(), 64)
    loss_b, grads_b, _ = port_step(setup, "apply_quant_trainable_blocked", x=xb)
    loss, grads, _ = port_step(setup, "apply_quant_trainable_blocked")
    assert loss_b == loss
    for name in grads:
        assert torch.equal(grads_b[name], grads[name]), name


def test_eval_mode_equals_apply_quantized(setup):
    model = copy.deepcopy(setup["tmodel"]).eval()
    q, qT, dinv = setup["tprep"]
    x = torch.from_numpy(setup["x"])
    with torch.no_grad():
        serve = model.apply_quantized(q, dinv, x)
        train_path = model.apply_quant_trainable(q, qT, dinv, x)
        blocked = model.apply_quant_trainable_blocked(q, qT, dinv, x)
    assert torch.equal(train_path, serve)
    torch.testing.assert_close(blocked, serve, rtol=1e-5, atol=1e-6)
    for a, b in zip(model.buffers(), setup["tmodel"].buffers()):
        assert torch.equal(a, b)  # eval mode leaves the running moments alone


def test_plain_path_equals_the_default_on_cpu(setup):
    for method in ("apply_quant_trainable", "apply_quant_trainable_blocked"):
        model = copy.deepcopy(setup["tmodel"])
        out = getattr(model, method)(*setup["tprep"], torch.from_numpy(setup["x"]))
        plain = getattr(copy.deepcopy(setup["tmodel"]), method)(
            *setup["tprep"], torch.from_numpy(setup["x"]), plain=True)
        assert torch.equal(out, plain)


@pytest.mark.parametrize("method", ["apply_quant_trainable", "apply_quant_trainable_blocked"])
def test_adam_trajectory_tracks_float32(method):
    """Eight Adam steps (lr 1e-2) on learnable labels, the sign of the
    aggregated first feature against its median: the int8 loss falls and
    ends within 0.05 of the float32 path's."""
    _, ta, x = spatial(320, 32)
    model = tp.BandedNodeGCN(in_channels=FEAT, hidden_dim=HIDDEN, num_layers=2,
                             generator=torch.Generator().manual_seed(0)).train()
    adj_norm, dinv = model.prepare(ta)
    xt = torch.from_numpy(x)
    agg = tq.banded_spmm_quant_xla(tq.quantize_band(adj_norm), xt)[:, 0]
    labels = (agg > agg.median()).long()
    prep = model.prepare_quant_trainable(ta)

    def run(forward):
        m = copy.deepcopy(model)
        opt = torch.optim.Adam(m.parameters(), lr=1e-2)
        losses = []
        for _ in range(8):
            opt.zero_grad()
            loss = F.cross_entropy(forward(m), labels)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        return losses

    l_q = run(lambda m: getattr(m, method)(*prep, xt))
    l_f = run(lambda m: m.apply_normalized(adj_norm, dinv, xt))
    assert l_q[-1] < l_q[0]
    assert abs(l_q[-1] - l_f[-1]) < 0.05, (l_q, l_f)
