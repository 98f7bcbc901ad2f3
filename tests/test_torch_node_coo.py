"""The port's COO node models (``NodeGCN``, ``NodeSAGE`` and their blocked
forms) against the JAX package's, with JAX's weights carried across by
``load_jax_params``.

Batches: a host-sampled one (``SampledNodeLoader``, fused, bitwise JAX's
by ``tests/test_torch_sampling.py``) and device-sampled ones with hop
blocks in both modes (the port's ``device_sample`` fed JAX's own uniform
draws, bitwise JAX's ``device_sample`` by
``tests/test_torch_device_sampling.py``).  Graph
``generate_spatial_graph(4096, degree=8, band=64, shortcut_frac=0.1)``,
64 seeds, fanout (4, 3), hidden 16, two layers, dropout 0.  The BatchNorm
affine and running moments are drawn from numpy.

Gates, the repository's float32 ones (``tests/test_torch_node_train.py``):
logits rtol 1e-4 / atol 1e-5 in eval and train mode; one train step's loss
(the Trainer's masked mean cross-entropy) rtol 1e-5, its gradients and the
BatchNorm running moments after it rtol 1e-4 / atol 1e-5, against
``jax.value_and_grad``.  Within the port, blocked against flat at JAX's own
gate (``tests/test_device_sampling.py:581-639``): logits and loss rtol 1e-5
/ atol 1e-6, gradients rtol 1e-4 / atol 1e-5.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.models as jm
import connectome_gnn_tpu.train as jt
import connectome_gnn_tpu_torch as tp
import connectome_gnn_tpu_torch.data as td
import connectome_gnn_tpu_torch.models as tm
from connectome_gnn_tpu_torch.models import load_jax_params
from connectome_gnn_tpu_torch.models.compat import reference_state_dict_from_params

LOGIT_RTOL, LOGIT_ATOL = 1e-4, 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
FLAT_RTOL, FLAT_ATOL = 1e-5, 1e-6
N, FEAT, HIDDEN, S, FANOUT = 4096, 5, 16, 64, (4, 3)
KINDS = ("NodeGCN", "NodeSAGE", "BlockedNodeGCN", "BlockedNodeSAGE")


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_draws(key, fanout, max_deg):
    """JAX ``device_sample``'s per-hop uniforms, from its own key splits."""
    draws, rows = [], S
    for f in fanout:
        key, sub = jax.random.split(key)
        draws.append(np.array(jax.random.uniform(sub, (rows, max_deg))))
        rows *= f
    return draws


@pytest.fixture(scope="module")
def setup():
    kw = dict(degree=8, band=64, shortcut_frac=0.1, seed=0)
    jg, tg = jd.generate_spatial_graph(N, **kw), td.generate_spatial_graph(N, **kw)
    labels = np.random.default_rng(1).integers(0, 2, N).astype(np.int32)
    seeds = np.random.default_rng(2).choice(N, S, replace=False)
    loader = dict(batch_size=S, fanout=FANOUT, seed=3, seed_nodes=seeds[:50])
    batches = {"host": (next(iter(td.SampledNodeLoader(tg, labels, device="cpu", **loader))),
                        next(iter(jd.SampledNodeLoader(jg, labels, **loader))))}
    tcsr, jcsr = td.DeviceGraphCSR.from_graph(tg, device="cpu"), jd.DeviceGraphCSR.from_graph(jg)
    key = jax.random.PRNGKey(5)
    draws = [torch.from_numpy(u) for u in jax_draws(key, FANOUT, max(8, *FANOUT))]
    mask = np.arange(S) < 50
    for dedup in (True, False):
        jb = jax.jit(jd.device_sample, static_argnums=3, static_argnames="dedup")(
            jcsr, jnp.asarray(np.where(mask, seeds, -1), jnp.int32), key, FANOUT, dedup=dedup)
        jb = dataclasses.replace(jb, labels=jnp.asarray(labels[seeds] * mask),
                                 label_mask=jnp.asarray(mask), seed_mask=jnp.asarray(mask))
        tb = td.device_sample(tcsr, torch.from_numpy(np.where(mask, seeds, -1)), None, FANOUT,
                              dedup=dedup, draws=draws)
        tb = dataclasses.replace(tb, labels=torch.from_numpy(labels[seeds] * mask).long(),
                                 label_mask=torch.from_numpy(mask), seed_mask=torch.from_numpy(mask))
        batches["dedup" if dedup else "multiset"] = tb, jb
    return batches


def models(kind, seed=0):
    """The JAX model, params and state, and the port's model carrying them."""
    jmodel = getattr(jm, kind)(in_channels=FEAT, hidden_dim=HIDDEN, num_layers=2)
    params, state = jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 10)
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
    tmodel = getattr(tm, kind)(in_channels=FEAT, hidden_dim=HIDDEN, num_layers=2)
    load_jax_params(tmodel, numpy_tree(params), numpy_tree(state))
    return jmodel, params, state, tmodel


CASES = [(k, b) for k in KINDS for b in ("host", "dedup")] + [
    ("NodeSAGE", "multiset"), ("BlockedNodeSAGE", "multiset")]


@pytest.mark.parametrize("kind,batch", CASES)
@pytest.mark.parametrize("train", [False, True])
def test_logits_match_jax(setup, kind, batch, train):
    tb, jb = setup[batch]
    jmodel, params, state, tmodel = models(kind)
    want, new_state = jax.jit(jmodel.apply, static_argnames="train")(params, state, jb, train=train)
    got = tmodel.train(train)(tb)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)
    ref = reference_state_dict_from_params(numpy_tree(params), numpy_tree(new_state),
                                           sage="SAGE" in kind)
    for i, bn in enumerate(tmodel.batch_norms):
        for buf in ("running_mean", "running_var"):
            np.testing.assert_allclose(getattr(bn, buf).numpy(), ref[f"batch_norms.{i}.{buf}"],
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)


def masked_ce(logits, labels, mask):
    ce = F.cross_entropy(logits, labels, reduction="none")
    m = mask.to(logits.dtype)
    return (ce * m).sum() / torch.clamp(m.sum(), min=1.0)


@pytest.mark.parametrize("kind,batch", CASES)
def test_train_step_matches_jax_value_and_grad(setup, kind, batch):
    tb, jb = setup[batch]
    jmodel, params, state, tmodel = models(kind, seed=1)

    def loss_fn(p):
        logits, new_state = jmodel.apply(p, state, jb, train=True)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, jb.labels)
        mask = jb.label_mask.astype(jnp.float32)
        return jnp.sum(ce * mask) / jnp.maximum(jnp.sum(mask), 1.0), new_state

    (want_loss, new_state), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want = reference_state_dict_from_params(numpy_tree(grads), numpy_tree(new_state),
                                            sage="SAGE" in kind)
    tmodel.train()
    loss = masked_ce(tmodel(tb), tb.labels, tb.label_mask)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    for i, bn in enumerate(tmodel.batch_norms):
        for buf in ("running_mean", "running_var"):
            np.testing.assert_allclose(getattr(bn, buf).numpy(), want[f"batch_norms.{i}.{buf}"],
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("family,batch", [("GCN", "dedup"), ("SAGE", "dedup"),
                                          ("SAGE", "multiset")])
@pytest.mark.parametrize("train", [False, True])
def test_blocked_matches_flat_within_the_port(setup, family, batch, train):
    """The blocked layers on the hop blocks against the flat COO layers on
    the same edges (the flat model ignores the blocks)."""
    tb, _ = setup[batch]
    _, _, _, blocked = models(f"BlockedNode{family}")
    flat = getattr(tm, f"Node{family}")(in_channels=FEAT, hidden_dim=HIDDEN, num_layers=2)
    flat.load_state_dict(blocked.state_dict())
    out = {}
    for name, model in (("blocked", blocked), ("flat", flat)):
        model.train(train)
        logits = model(tb)
        loss = masked_ce(logits, tb.labels, tb.label_mask)
        loss.backward()
        out[name] = logits.detach(), loss.detach(), {k: p.grad for k, p in model.named_parameters()}
    (lb, sb, gb), (lf, sf, gf) = out["blocked"], out["flat"]
    torch.testing.assert_close(lb, lf, rtol=FLAT_RTOL, atol=FLAT_ATOL)
    torch.testing.assert_close(sb, sf, rtol=FLAT_RTOL, atol=FLAT_ATOL)
    for name in gf:
        torch.testing.assert_close(gb[name], gf[name], rtol=GRAD_RTOL, atol=GRAD_ATOL, msg=name)
    for a, b in zip(blocked.buffers(), flat.buffers()):
        torch.testing.assert_close(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("kind", KINDS + ("DeviceSampledGCN", "DeviceSampledSAGE"))
def test_load_jax_params_carries_jax_init(kind):
    """JAX's shared ``init_node_gcn_params`` / ``init_node_sage_params``
    into each node model, and into a ``DeviceSampledModel`` wrapping one,
    whose ``state_dict`` is its inner model's."""
    sage = "SAGE" in kind
    init = jm.node_sage.init_node_sage_params if sage else jm.node_gcn.init_node_gcn_params
    params, state = init(jax.random.PRNGKey(3), FEAT, HIDDEN, 3, 2)
    if kind.startswith("DeviceSampled"):
        g = td.generate_spatial_graph(256, degree=4, band=16, seed=1)
        make = td.device_sampled_sage if sage else td.device_sampled_gcn
        model = make(g, hidden_dim=HIDDEN, num_classes=3, fanout=(2, 2), device="cpu")
    else:
        model = getattr(tm, kind)(in_channels=FEAT, hidden_dim=HIDDEN, num_classes=3,
                                  num_layers=2)
    load_jax_params(model, numpy_tree(params), numpy_tree(state))
    want = reference_state_dict_from_params(numpy_tree(params), numpy_tree(state), sage=sage)
    got = model.state_dict()
    assert set(got) - {k for k in got if k.endswith("num_batches_tracked")} == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), value, err_msg=name)
    banded = (tp.BandedNodeSAGE if sage else tp.BandedNodeGCN)(FEAT, HIDDEN, 3, num_layers=2)
    banded.load_state_dict(got)  # the banded and COO families share their keys


def test_same_init_as_the_banded_family():
    """Weights are drawn in the banded node models' order, from the same
    default generator."""
    for coo, banded in ((tp.NodeGCN, tp.BandedNodeGCN), (tp.NodeSAGE, tp.BandedNodeSAGE)):
        a, b = coo(FEAT, HIDDEN, 2, num_layers=2), banded(FEAT, HIDDEN, 2, num_layers=2)
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb), ka


def test_trainer_predicts_and_evaluates_node_batches_as_jax():
    """``Trainer.predict`` on host-sampled batches takes ``model(batch)``
    and keeps the real seeds (``graph_mask``), unlabelled ones included;
    ``evaluate`` counts the labelled seeds.  Against JAX's Trainer."""
    g = jd.generate_spatial_graph(1024, degree=6, band=32, seed=4)
    tg = td.generate_spatial_graph(1024, degree=6, band=32, seed=4)
    labels = np.random.default_rng(0).integers(0, 2, 1024).astype(np.int32)
    kw = dict(batch_size=S, fanout=FANOUT, shuffle=False, seed_nodes=np.arange(150) * 5)
    jmodel, params, state, tmodel = models("NodeGCN")
    with pytest.warns(UserWarning):
        want = jt.Trainer(jmodel, params=params, state=state).predict(
            jd.SampledNodeLoader(g, **kw), prefer_fused=True)
    trainer = tp.Trainer(copy.deepcopy(tmodel), device="cpu")
    with pytest.warns(UserWarning, match="COO"):
        got = trainer.predict(td.SampledNodeLoader(tg, device="cpu", **kw))
    assert got.shape == (150, 2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    ev = trainer.evaluate(td.SampledNodeLoader(tg, labels, device="cpu", **kw))
    want_ev = jt.Trainer(jmodel, params=params, state=state).evaluate(
        jd.SampledNodeLoader(g, labels, **kw))
    assert ev["total"] == want_ev["total"] == 150
    np.testing.assert_allclose(ev["loss"], want_ev["loss"], rtol=LOSS_RTOL)
