"""Operations and bytes counted from a configuration's shapes, and the
H100's published peaks they are held against (NVIDIA's data sheet, SXM,
dense, at the full 700 W power limit).

These count the work a configuration asks for, whatever implements it: a
later kernel that computes the same product is held to the same work.
"""

from __future__ import annotations

#: dense bf16 tensor-core peak, FLOP/s: the ``mfu`` metrics' denominator
PEAK_FLOPS = 989e12
#: HBM3 bandwidth, bytes/s
PEAK_BYTES_PER_S = 3.35e12


def band_width_blocks(config: dict) -> int:
    """W: diagonal blocks a side that hold a sender within ``±band`` of its
    receiver."""
    return (config["block"] - 1 + config["band"]) // config["block"]


def num_edges(config: dict) -> int:
    return config["num_nodes"] * config["degree"]


def layer_widths(config: dict):
    """``(F_in, F_out)`` of each layer."""
    f, h = config["in_channels"], config["hidden_dim"]
    return [(f if i == 0 else h, h) for i in range(config["num_layers"])]


def aggregated_widths(config: dict) -> list:
    """The features each layer's band product carries: ``F_out`` where the
    model projects before it aggregates (GCN), ``F_in`` where it
    aggregates first (SAGE); the configuration's ``aggregates`` says
    which."""
    after = config["aggregates"] == "after_projection"
    return [f_out if after else f_in for f_in, f_out in layer_widths(config)]


def forward_flops(config: dict, nodes: float, edges: float, head_rows: float) -> float:
    """One forward: ``2·E·F`` a layer's neighbor aggregation (at the width
    it carries), ``2·N·k·F_in·F_out`` its weight product (``k`` the
    configuration's ``projection_inputs``: 2 where SAGE projects the
    concatenation of a node and its mean), and the head over
    ``head_rows`` nodes."""
    k = config["projection_inputs"]
    total = 0
    for (f_in, f_out), f_agg in zip(layer_widths(config), aggregated_widths(config)):
        total += 2 * nodes * k * f_in * f_out + 2 * edges * f_agg
    return total + 2 * head_rows * config["hidden_dim"] * config["num_classes"]


def unit_flops(config: dict, workload: dict, shapes=None):
    """Operations of one unit of a workload: ``forwards_per_unit`` forwards
    (a training step is three: the forward, and the backward's two
    products a forward product), over the configuration's whole graph or,
    where the workload is ``counted_over`` the sample, over ``shapes``
    (the sample's nodes, edges and head rows; None without one)."""
    if workload.get("counted_over") == "sample":
        if shapes is None:
            return None
        size = shapes["nodes"], shapes["edges"], shapes["head_rows"]
    else:
        size = config["num_nodes"], num_edges(config), config["num_nodes"]
    return workload["forwards_per_unit"] * forward_flops(config, *size)


def band_product_bytes(config: dict, band_bytes_per_entry: int, features: int) -> int:
    """Least bytes of one band product ``A @ x``: every band entry once at
    its stored width (with a float32 scale a tile when it is int8), ``x``
    read once and the output written once, float32."""
    block, n = config["block"], config["num_nodes"]
    blocks = -(-n // block)
    tiles = blocks * (2 * band_width_blocks(config) + 1)
    band = tiles * block * block * band_bytes_per_entry
    scales = tiles * 4 if band_bytes_per_entry == 1 else 0
    return band + scales + 2 * n * features * 4


def band_product_seconds(config: dict, band_bytes_per_entry: int, features: int) -> float:
    return band_product_bytes(config, band_bytes_per_entry, features) / PEAK_BYTES_PER_S


def band_pass_seconds(config: dict, band_bytes_per_entry: int) -> float:
    """Least seconds of one pass over every layer's band product, each at
    the width it carries."""
    return sum(band_product_seconds(config, band_bytes_per_entry, f)
               for f in aggregated_widths(config))
