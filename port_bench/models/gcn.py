"""GCN (Kipf & Welling, arXiv:1609.02907) on both sides: the program's
``BandedNodeGCN`` and ``device_sampled_gcn``, and the reference's
:func:`~port_bench.reference.model.gcn_logits` over the symmetric-normalized
adjacency.  The program is imported only when its model is built."""

from __future__ import annotations

from port_bench.reference import model as ref


def parameter_shapes(config: dict) -> dict:
    """Parameters and BatchNorm moments by the program's names, in order."""
    f, h = config["in_channels"], config["hidden_dim"]
    shapes = {}
    for i in range(config["num_layers"]):
        shapes[f"convs.{i}.linear.weight"] = (h, f if i == 0 else h)
        shapes[f"convs.{i}.bias"] = (h,)
    return {**shapes, **ref.norm_and_head_shapes(config)}


def program_model(config: dict):
    from connectome_gnn_tpu_torch.models.node_gcn import BandedNodeGCN

    return BandedNodeGCN(config["in_channels"], config["hidden_dim"], config["num_classes"],
                         config["num_layers"])


def reference_operator(adj, config: dict, bits):
    """The normalized adjacency quantized at ``bits`` (None: float32), and
    the self-loop term ``d²``."""
    return ref.gcn_adjacency(adj, config["block"], bits)


def reference_logits(p: dict, operator, x, config: dict, *, train: bool, tf32: bool = False):
    norm, self_norm = operator
    return ref.gcn_logits(p, norm, self_norm, x, config["num_layers"], train=train, tf32=tf32)


def sampled_program(graph, config: dict, device):
    from connectome_gnn_tpu_torch.data.device_sampling import device_sampled_gcn

    return device_sampled_gcn(graph, hidden_dim=config["hidden_dim"],
                              num_classes=config["num_classes"], fanout=config["fanout"],
                              device=device)


def sampled_reference_loss(p: dict, seeds, key: int, graph, labels, labelled, config: dict, *,
                           tf32: bool = False):
    """One sampled step's loss over the reference's own sample, and the
    sample's ``(nodes, edges)``."""
    return ref.sampled_gcn_loss(p, seeds, key, config["fanout"], config["degree"], graph.senders,
                                graph.weights, graph.features, labels, labelled,
                                config["num_layers"], tf32=tf32)
