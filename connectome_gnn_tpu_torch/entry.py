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
step of a small GCN over stacked batches, and, when ``n >= 4`` is even, one
2-D (data × edge) step of a hybrid giant-graph cohort, whose exchange runs
every collective family: the halo shifts, the remainder's all-to-alls and
the sums over both axes.  The JAX function's device-sampled and
graph-sharded sampling dry runs belong to slice E3 of the port.

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
    print("dryrun_multichip: the device-sampled and graph-sharded sampling dry runs wait for "
          "slice E3 of the port")
    if n_devices >= 4 and n_devices % 2 == 0:
        _dryrun_2d(mesh.device, 2, n_devices // 2)


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
