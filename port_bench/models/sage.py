"""GraphSAGE with a weighted mean (Hamilton et al., arXiv:1706.02216) on
both sides: the program's ``BandedNodeSAGE`` and the reference's
:func:`~port_bench.reference.model.sage_logits`, the mean's numerator over
the (quantized) raw-weight adjacency and its denominator from the float32
weights.  The program is imported only when its model is built."""

from __future__ import annotations

from port_bench.reference import model as ref


def parameter_shapes(config: dict) -> dict:
    """Parameters and BatchNorm moments by the program's names, in order."""
    f, h = config["in_channels"], config["hidden_dim"]
    shapes = {}
    for i in range(config["num_layers"]):
        shapes[f"convs.{i}.linear.weight"] = (h, 2 * (f if i == 0 else h))
        shapes[f"convs.{i}.linear.bias"] = (h,)
    return {**shapes, **ref.norm_and_head_shapes(config)}


def program_model(config: dict):
    from connectome_gnn_tpu_torch.models.node_sage import BandedNodeSAGE

    return BandedNodeSAGE(config["in_channels"], config["hidden_dim"], config["num_classes"],
                          config["num_layers"])


def reference_operator(adj, config: dict, bits):
    """The raw-weight adjacency quantized at ``bits`` (None: float32), and
    the mean's denominator from the unquantized weights."""
    return adj.quantized(config["block"], bits), adj.receiver_sum()


def reference_logits(p: dict, operator, x, config: dict, *, train: bool, tf32: bool = False):
    adj_q, w_sum = operator
    return ref.sage_logits(p, adj_q, w_sum, x, config["num_layers"], train=train, tf32=tf32)
