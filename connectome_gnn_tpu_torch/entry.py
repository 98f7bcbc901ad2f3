"""The flagship model and an example batch, ready to run: the analog of the
JAX package's ``__graft_entry__.entry()`` (``__graft_entry__.py:27-35``).

``entry()`` returns ``(forward, (model, batch))``: the flagship
:class:`~connectome_gnn_tpu_torch.models.GCNConnectome` (hidden 64, 3
layers, weights from a generator seeded 0) and a COO batch of 16 subjects
× 84 regions (``generate_dataset(seed=42)``, ``collate_graphs``), both on
``device`` (default ``cuda``; without a card it raises, and
``device="cpu"`` asks for the CPU).  ``forward(model, batch)`` gives the
eval-mode logits ``[16, 2]``.

    python -m connectome_gnn_tpu_torch.entry    # prints: entry forward ok: (16, 2)

``dryrun_multichip(n)`` (``__graft_entry__.py:39``) builds an ``n``-shard
``("data",)`` mesh on the caller's device, runs one data-parallel train
step of a small GCN over stacked batches, one device-sampled data-parallel
step (the CSR on the mesh's device, seed rows sharded,
``__graft_entry__.py:154``), one graph-sharded sampled step with the
broadcast exchange and one with the compacted exchange, asserting no
overflow (``__graft_entry__.py:84``), and, when ``n >= 4`` is even, one 2-D
(data × edge) step of a hybrid giant-graph cohort, whose exchange runs
every collective family: the halo shifts, the remainder's all-to-alls and
the sums over both axes.

    python -m connectome_gnn_tpu_torch.entry --dryrun-multichip 8 --device cpu
"""

from __future__ import annotations

import argparse

import torch

from connectome_gnn_tpu_torch.data import collate_graphs, generate_dataset
from connectome_gnn_tpu_torch.data.batch import card_by_default
from connectome_gnn_tpu_torch.models import GCNConnectome


def forward(model: torch.nn.Module, batch) -> torch.Tensor:
    """Eval-mode logits ``[B, num_classes]`` of ``model`` on ``batch``."""
    model.eval()
    with torch.inference_mode():
        return model(batch)


def entry(device=None):
    """``(forward, (model, batch))`` on the flagship GCN, on ``device``."""
    device = card_by_default(device, "entry()")
    model = GCNConnectome(in_channels=5, hidden_dim=64, num_classes=2, num_layers=3,
                          generator=torch.Generator().manual_seed(0)).to(device)
    graphs = generate_dataset(num_subjects=16, num_regions=84, seed=42)
    return forward, (model, collate_graphs(graphs, device=device))


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One data-parallel train step over an ``n_devices``-shard mesh on
    ``device`` (default ``cuda``), and one 2-D step when ``n_devices >= 4``
    is even; prints a line for each."""
    from connectome_gnn_tpu_torch.data import ConnectomeDataLoader
    from connectome_gnn_tpu_torch.parallel import create_mesh, make_dp_train_step
    from connectome_gnn_tpu_torch.train import reference_adam

    device = card_by_default(device, "dryrun_multichip()")
    mesh = create_mesh((n_devices,), ("data",), device=device)
    model = GCNConnectome(in_channels=5, hidden_dim=32, num_classes=2, num_layers=2,
                          generator=torch.Generator().manual_seed(0)).to(mesh.device)
    graphs = generate_dataset(num_subjects=2 * n_devices, num_regions=20, seed=0)
    loader = ConnectomeDataLoader(graphs, batch_size=2 * n_devices, shuffle=False,
                                  num_shards=n_devices)
    step = make_dp_train_step(model, reference_adam()(model.parameters()), mesh)
    loss, n = step(mesh.place(next(iter(loader))))
    print(f"dryrun_multichip({n_devices}): ok: loss={float(loss):.4f}, n_real={int(n)} graphs "
          f"across {n_devices} shards on {mesh.device}")
    _dryrun_device_sampled(mesh)
    _dryrun_graph_sharded_sampling(mesh)
    if n_devices >= 4 and n_devices % 2 == 0:
        _dryrun_2d(mesh.device, 2, n_devices // 2)


def _dryrun_device_sampled(mesh) -> None:
    """One device-sampled data-parallel train step: the CSR on the mesh's
    device, the seed rows sharded, sampling inside the step."""
    import numpy as np

    from connectome_gnn_tpu_torch.data import device_sampled_gcn, generate_spatial_graph
    from connectome_gnn_tpu_torch.parallel import make_device_sampled_dp_step, replicate_csr

    D = mesh.size
    g = generate_spatial_graph(32 * D, degree=4, band=8, seed=2)
    labels = (g.degree() > np.median(g.degree())).astype(np.int32)
    model = device_sampled_gcn(g, hidden_dim=16, fanout=(3, 3), device=mesh.device)
    loader = model.make_loader(np.arange(g.num_nodes), labels, batch_size=4 * D, num_shards=D,
                               shuffle=False)
    step = make_device_sampled_dp_step(model, torch.optim.Adam(model.parameters(), lr=1e-3), mesh)
    loss, n = step(mesh.place(next(iter(loader)).packed), replicate_csr(model.csr, mesh))
    print(f"dryrun_multichip device-sampled DP ({D} shards): ok: loss={float(loss):.4f}, "
          f"n_real={int(n)} seed nodes")


def _dryrun_graph_sharded_sampling(mesh) -> None:
    """One graph-sharded sampled train step with each exchange: adjacency
    and features node-partitioned over the mesh, rows resolved at their
    owners by all_gather / all_to_all."""
    import numpy as np

    from connectome_gnn_tpu_torch.data import generate_spatial_graph
    from connectome_gnn_tpu_torch.models.node_coo import BlockedNodeSAGE
    from connectome_gnn_tpu_torch.parallel import (
        CompactionConfig,
        ShardedGraphCSR,
        make_graph_sharded_train_step,
    )

    D, S = mesh.size, 4
    g = generate_spatial_graph(32 * D, degree=4, band=8, seed=4)
    labels = (g.degree() > np.median(g.degree())).astype(np.int32)
    sg = ShardedGraphCSR.partition(g, D, device=mesh.device)
    keys = torch.stack([torch.zeros(D, dtype=torch.long), torch.arange(D)], dim=1)
    seeds = np.arange(D * S).reshape(D, S)
    # the compacted step spreads each shard's seeds over all shards (the
    # loader's uniform draw), so the capacity bound holds and it is exact
    stride = g.num_nodes // (D * S)
    spread = np.arange(D * S).reshape(S, D).T * stride
    for name, comp, s in (("graph-sharded sampling", None, seeds),
                          ("graph-sharded COMPACTED exchange", CompactionConfig(alpha=2.0,
                                                                                rounds=2), spread)):
        model = BlockedNodeSAGE(in_channels=5, hidden_dim=16, num_layers=2).to(mesh.device)
        step = make_graph_sharded_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                                             mesh, (3, 3), compaction=comp)
        out = step(sg, torch.from_numpy(s), keys, torch.from_numpy(labels[s]),
                   torch.ones(s.shape, dtype=torch.bool))
        tail = f"n_real={int(out[1])} seeds"
        if comp is not None:
            if int(out[2]) != 0:
                raise RuntimeError(f"the compacted exchange overflowed: {int(out[2])}")
            tail = f"overflow={int(out[2])}"
        print(f"dryrun_multichip {name} ({D} node shards): ok: loss={float(out[0]):.4f}, {tail}")


def _dryrun_2d(device, d_data: int, d_edge: int) -> None:
    """One 2-D (data × edge) step over a cohort of hybrid giant graphs."""
    import numpy as np

    from connectome_gnn_tpu_torch.data import generate_spatial_graph
    from connectome_gnn_tpu_torch.ops import to_hybrid
    from connectome_gnn_tpu_torch.parallel import (
        ShardedBandedGCN,
        create_mesh,
        make_banded_train_step_2d,
        partition_hybrid_cohort,
    )

    mesh = create_mesh((d_data, d_edge), ("data", "edge"), device=device)
    model = ShardedBandedGCN(in_channels=5, hidden_dim=16, num_layers=2,
                             generator=torch.Generator().manual_seed(0)).to(mesh.device)
    hybrids, feats, labels = [], [], []
    for i in range(d_data):
        g = generate_spatial_graph(16 * d_edge, degree=4, band=12, seed=i, shortcut_frac=0.2)
        labels.append((g.degree() > np.median(g.degree())).astype(np.int32))
        feats.append(g.node_features)
        hybrids.append(to_hybrid(g.edge_index[0], g.edge_index[1], g.edge_weight, g.num_nodes,
                                 block=8, bandwidth=2))
    stacked = mesh.place(partition_hybrid_cohort(hybrids, feats, d_edge, labels=labels))
    step = make_banded_train_step_2d(model, torch.optim.Adam(model.parameters(), lr=1e-3), mesh)
    loss, n = step(stacked)
    print(f"dryrun_multichip 2-D ({d_data}x{d_edge} data x edge): ok: loss={float(loss):.4f}, "
          f"n_real={int(n)} labelled nodes; bytes moved {dict(mesh.bytes_moved)}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="default: cuda")
    parser.add_argument("--dryrun-multichip", type=int, default=None, metavar="N",
                        help="run dryrun_multichip(N) instead of the forward")
    args = parser.parse_args(argv)
    if args.dryrun_multichip is not None:
        dryrun_multichip(args.dryrun_multichip, args.device)
        return
    fn, example = entry(args.device)
    logits = fn(*example)
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"entry forward gave non-finite logits: {logits}")
    print(f"entry forward ok: {tuple(logits.shape)}")


if __name__ == "__main__":
    main()
