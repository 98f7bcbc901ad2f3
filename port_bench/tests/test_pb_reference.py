"""The plain reference against the port's CPU path at small sizes: the
quantized adjacency, the float32 SAGE forward, a float32 GCN train step,
and the device sampler's sample.  (The tests may load the program; the
reference itself never does.)"""

import numpy as np
import torch
import torch.nn.functional as F

from port_bench import inputs, parts
from port_bench.reference import compare
from port_bench.reference import model as ref

SMALL = dict(model="gcn", num_nodes=3000, degree=12, band=200, block=128, in_channels=16,
             hidden_dim=16, num_layers=2, num_classes=2, labelled_share=0.5, fanout=[4, 3],
             batch_size=64)
SEED = 2**31 + 12345


def weights(config, serving):
    return inputs.make_weights(config, SEED, "cpu", serving=serving,
                               shapes=parts.model(config["model"]).parameter_shapes(config))


def graph(config=SMALL):
    return inputs.make_graph(config, SEED, "cpu")


def band(g, config=SMALL):
    from connectome_gnn_tpu_torch.ops.banded import to_banded

    return to_banded(g.senders.numpy(), g.receivers.numpy(), g.weights.numpy(),
                     config["num_nodes"], block=config["block"], device="cpu")


def at(band_tensor, adj, block):
    """The band's entries at the adjacency's (receiver, sender) pairs."""
    rb, sb = adj.receivers // block, adj.senders // block
    W = (band_tensor.shape[1] - 1) // 2
    return band_tensor[rb, sb - rb + W, adj.receivers % block, adj.senders % block]


def test_inputs_repeat_for_a_seed_and_change_with_it():
    a, b = graph(), graph()
    assert torch.equal(a.senders, b.senders) and torch.equal(a.weights, b.weights)
    c = inputs.make_graph(SMALL, SEED + 1, "cpu")
    assert not torch.equal(a.senders, c.senders)
    assert ((a.senders - a.receivers).abs() <= SMALL["band"]).all()
    assert 0.0 < float(a.weights.min()) and float(a.weights.max()) < 1.0


def test_quantized_normalized_adjacency_is_the_ports():
    from connectome_gnn_tpu_torch.ops.banded import gcn_normalize_banded
    from connectome_gnn_tpu_torch.ops.banded_quant import dequantize_band, quantize_band

    g = graph()
    a = band(g)
    q = quantize_band(gcn_normalize_banded(a)[0])
    port = at(dequantize_band(q).band, ref.Adjacency.coalesce(
        g.senders, g.receivers, g.weights, SMALL["num_nodes"]), SMALL["block"])
    adj = ref.Adjacency.coalesce(g.senders, g.receivers, g.weights, SMALL["num_nodes"])
    mine, _ = ref.gcn_adjacency(adj, SMALL["block"], 8)
    # the normalization's sums run in another order, so a tile's scale, and
    # now and then an entry's rounding, moves by an ulp
    gap = (mine.values - port).abs()
    assert float(gap.max()) <= float(q.scales.max()) * 1.0001
    assert float((gap <= 1e-6 * port.abs()).float().mean()) > 0.999


def test_float32_sage_forward_is_the_ports():
    from connectome_gnn_tpu_torch.models.node_sage import BandedNodeSAGE

    cfg = {**SMALL, "model": "sage"}
    g = graph(cfg)
    p = weights(cfg, serving=True)
    model = BandedNodeSAGE(16, 16, 2, 2).eval()
    state = model.state_dict()
    for k, v in p.items():
        state[k].copy_(v)
    x = inputs.request_features(cfg, SEED, 0, "cpu")
    with torch.no_grad():
        want = model(band(g, cfg), x)
    adj = ref.Adjacency.coalesce(g.senders, g.receivers, g.weights, cfg["num_nodes"])
    got = ref.sage_logits(p, adj, adj.receiver_sum(), x, 2)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_float32_gcn_train_step_is_the_ports():
    from connectome_gnn_tpu_torch.models.node_gcn import BandedNodeGCN
    from connectome_gnn_tpu_torch.train.trainer import reference_adam

    g = graph()
    p0 = weights(SMALL, serving=False)
    labels, labelled = inputs.node_labels(SMALL, SEED, "cpu")
    model = BandedNodeGCN(16, 16, 2, 2).train()
    state = model.state_dict()
    for k, v in p0.items():
        state[k].copy_(v)
    adj_norm, dinv = model.prepare(band(g))
    opt = reference_adam()(model.parameters())
    losses = []
    for _ in range(3):
        opt.zero_grad()
        ce = F.cross_entropy(model.apply_normalized(adj_norm, dinv, g.features), labels,
                             reduction="none")
        loss = (ce * labelled).sum() / labelled.sum()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if len(losses) == 1:
            grads = {k: opt.state[w]["exp_avg"] / 0.1 for k, w in model.named_parameters()}
    names = dict(model.named_parameters())
    change = {k: names[k].detach() - p0[k] for k in names}
    got = {"losses": losses, "grads": grads, "change": change}

    adj = ref.Adjacency.coalesce(g.senders, g.receivers, g.weights, SMALL["num_nodes"])
    norm, self_norm = ref.gcn_adjacency(adj, SMALL["block"], None)
    want = ref.train_steps(p0, list(names), 3, lambda q, s: ref.masked_cross_entropy(
        ref.gcn_logits(q, norm, self_norm, g.features, 2), labels, labelled))
    readings = compare.train_readings(got, want)
    assert readings["loss_gap"] < 1e-6 and readings["grad_gap"] < 1e-4
    assert readings["change_gap"] < 1e-3


def test_the_sample_is_the_device_samplers():
    from connectome_gnn_tpu_torch.data.device_sampling import DeviceGraphCSR, device_sample
    from connectome_gnn_tpu_torch.data.graph import ConnectomeGraph

    g = graph()
    csr = DeviceGraphCSR.from_graph(ConnectomeGraph(
        node_features=g.features.numpy(),
        edge_index=torch.stack([g.senders, g.receivers]).int().numpy(),
        edge_weight=g.weights.numpy()), device="cpu")
    seeds = inputs.seed_pool(SMALL, SEED, 64, "cpu")
    key = ref.sample_key(77, 0, 0)
    port = device_sample(csr, seeds, torch.tensor([0, key]), SMALL["fanout"])
    real = port.node_ids[port.node_ids >= 0]
    snd, rcv, eid, nodes = ref.sample_blocks(seeds, key, SMALL["fanout"], SMALL["degree"],
                                             g.senders)
    assert torch.equal(torch.sort(real).values, torch.sort(nodes).values)
    assert torch.equal(nodes[:64], seeds)
    ids = port.node_ids.clamp(min=0)
    live = port.edge_weight > 0
    port_edges = sorted(zip(ids[port.senders[live]].tolist(), ids[port.receivers[live]].tolist(),
                            port.edge_weight[live].tolist()))
    mine = sorted(zip(snd.tolist(), rcv.tolist(), g.weights[eid].tolist()))
    assert port_edges == mine


def test_hop_uniforms_are_24_bit_and_repeat():
    u = ref.hop_uniforms(12345, 1, 8, 38, "cpu")
    assert torch.equal(u, ref.hop_uniforms(12345, 1, 8, 38, "cpu"))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert torch.equal(u * 2**24, (u * 2**24).round())
    assert not torch.equal(u, ref.hop_uniforms(12345, 0, 8, 38, "cpu"))
    assert np.isclose(float(u.mean()), 0.5, atol=0.1)
