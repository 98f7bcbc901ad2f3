"""Inputs made from ``--seed``: the graph, the weights, the labels, the
request features and the seed pools.  Both sides get these same tensors;
nothing here imports the program.

Every draw comes from a ``torch.Generator`` on the device of the run,
seeded from ``(seed, tag)`` through ``numpy.random.SeedSequence``, in a few
large calls, so the same seed gives the same inputs and any seed up to
2**63 works.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def sub_seed(seed: int, *tags: int | str) -> int:
    """A 63-bit seed for the stream ``tags`` of run seed ``seed``."""
    words = [int(seed) % (1 << 63)]
    for t in tags:
        word = t if isinstance(t, int) else int.from_bytes(t.encode(), "little")
        words.append(word % (1 << 63))
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


@dataclass
class Graph:
    """A spatially local graph, receiver-major: node ``r`` receives edges
    ``r·degree ... r·degree + degree - 1`` from senders drawn uniformly
    within ``±band`` positions (clipped at the ends), with Beta(2, 5)
    weights; features are standard normal."""

    senders: torch.Tensor  # int64 [E]
    receivers: torch.Tensor  # int64 [E]
    weights: torch.Tensor  # float32 [E]
    features: torch.Tensor  # float32 [N, F]
    num_nodes: int


def make_graph(config: dict, seed: int, device) -> Graph:
    n, degree, band = config["num_nodes"], config["degree"], config["band"]
    g = generator(device, seed, "graph")
    receivers = torch.arange(n, device=device).repeat_interleave(degree)
    senders = (receivers + torch.randint(-band, band + 1, receivers.shape, generator=g,
                                         device=device)).clamp_(0, n - 1)
    # Beta(2, 5) is the second smallest of six uniforms; in chunks so the
    # temporary stays small
    weights = torch.empty(receivers.shape, dtype=torch.float32, device=device)
    for lo in range(0, weights.numel(), 1 << 23):
        hi = min(lo + (1 << 23), weights.numel())
        u = torch.rand((hi - lo, 6), generator=g, device=device)
        weights[lo:hi] = u.topk(2, dim=1, largest=False).values[:, 1]
    features = torch.randn((n, config["in_channels"]), generator=g, device=device)
    return Graph(senders, receivers, weights, features, n)


def request_features(config: dict, seed: int, index: int, device, out=None) -> torch.Tensor:
    """The node features of serving request ``index``: a fresh snapshot
    over the fixed graph, drawn into ``out`` where it is given."""
    g = generator(device, seed, "request", index)
    return torch.randn((config["num_nodes"], config["in_channels"]), generator=g, device=device,
                       out=out)


def node_labels(config: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(labels int64 [N], labelled bool [N])``: a class a node, and the
    labelled share of the nodes that the loss reads."""
    g = generator(device, seed, "labels")
    n = config["num_nodes"]
    labels = torch.randint(0, config["num_classes"], (n,), generator=g, device=device)
    labelled = torch.rand((n,), generator=g, device=device) < config.get("labelled_share", 1.0)
    return labels, labelled


def seed_pool(config: dict, seed: int, size: int, device) -> torch.Tensor:
    """``size`` distinct nodes, int64, in a seeded order."""
    g = generator(device, seed, "pool")
    return torch.randperm(config["num_nodes"], generator=g, device=device)[:size]


def make_weights(config: dict, seed: int, device, *, serving: bool,
                 shapes: dict[str, tuple[int, ...]]) -> dict[str, torch.Tensor]:
    """Every parameter and BatchNorm moment of ``shapes`` (by the program's
    names, from the model file) from one uniform draw on the device.
    Matrices are Xavier-uniform and the head PyTorch's default; biases
    ``U(±1/√fan_in)`` except GCN's conv bias, 0.  For training
    BatchNorm starts at its identity; for serving its affine and moments
    are drawn, so eval-mode BatchNorm is not the identity."""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=generator(device, seed, "weights"), device=device) * 2 - 1
    out, at = {}, 0
    for name, shape in shapes.items():
        u = flat[at : at + math.prod(shape)].view(shape)
        at += u.numel()
        if name.endswith("linear.weight"):
            out[name] = u * math.sqrt(6.0 / (shape[0] + shape[1]))
        elif name.startswith("head.") or name.endswith("linear.bias"):
            fan_in = shapes[name.rsplit(".", 1)[0] + ".weight"][1]
            out[name] = u / math.sqrt(fan_in)
        elif name.startswith("convs."):  # GCN conv bias
            out[name] = torch.zeros_like(u)
        elif not serving:
            out[name] = torch.ones_like(u) if name.endswith(("weight", "running_var")) else \
                torch.zeros_like(u)
        elif name.endswith("running_var"):
            out[name] = 1.0 + 0.5 * u
        elif name.endswith("running_mean"):
            out[name] = 0.1 * u
        elif name.endswith("weight"):
            out[name] = 1.0 + 0.5 * u
        else:
            out[name] = 0.5 * u
    return {k: v.contiguous() for k, v in out.items()}
